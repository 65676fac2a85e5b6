"""Objecter: thin client-side op router to the primary OSD.

Port of ``ceph_tpu/osd/objecter.py``.

Reference: src/osdc/Objecter.{h,cc} -- the librados client computes
placement from the osdmap (``_calc_target``, Objecter.cc:2784), sends ONE
op to the primary OSD of the object's PG (``_send_op`` :3223), and
retries/redirects when the map changes or the primary dies.  The primary
OSD hosts the EC engine (``OSDShard.host_pool`` -> ``ECBackend``) and
fans out sub-ops to the acting set; this class never touches chunks.

Failover: while waiting for a reply the Objecter probes the primary
(``client_probe_retries`` attempts of ``client_probe_grace`` each); an
unreachable primary is marked down and the op is resent -- same reqid,
exponential backoff with jitter between attempts -- to the next up shard
of the acting set (the reference's analogue: a new osdmap epoch promotes
a new primary and the Objecter re-targets).  Every op carries an
``osd_reqid_t``-style reqid ``(client, incarnation, tid)``; the OSDs
persist applied ops' reqids + results as PG-log dup entries, so a resend
that races a completed-but-unacknowledged op is answered with the
ORIGINAL result instead of re-executing -- exactly-once across primary
failover, for non-idempotent ops (omap_cas, exec, snap_rollback)
included.  A shard whose PG is peering answers ``backoff`` instead of
queueing; the op parks until that OSD's ``backoff_release`` (or the op
deadline) and then resends (the RADOS PG backoff protocol).
WriteConflict refusals -- possible only transiently around a failover,
when an engine with a cold version view serves its first write -- are
retried once under a FRESH reqid (the refusal teaches the engine the
winning version; the losing attempt's dups must not answer the retry).
See docs/resilience.md.
"""

from __future__ import annotations

import asyncio
import itertools
import os
import random
from typing import Dict, List, Optional

from ceph_tpu_torch.osd.ecbackend import ObjectIncomplete
from ceph_tpu_torch.profiling import ledger as _profiler
from ceph_tpu_torch.utils import trace

#: wire-tax cost center: the client-side synchronous submit work
#: (reqid/tid mint, op-dict build, trace stamping) per send attempt
_PS_SUBMIT = _profiler.stage("objecter.submit")
from ceph_tpu_torch.utils.optracker import OpTracker
from ceph_tpu_torch.utils.perf import PerfCounters

#: error type names coming back over the wire -> local exception classes
_EXCEPTIONS = {
    "ObjectIncomplete": ObjectIncomplete,
    "FileNotFoundError": FileNotFoundError,
    "KeyError": KeyError,
    "ValueError": ValueError,
    "RuntimeError": RuntimeError,
    "PermissionError": PermissionError,  # OSDCap denial (-EACCES)
}

#: per-process Objecter incarnation source: the reqid's middle field.
#: Two Objecters sharing a name (client restart, parallel harnesses)
#: must never mint colliding reqids -- the incarnation tie-breaks, the
#: role of the client's global_id + inc in the reference osd_reqid_t.
#: seeded with process-unique entropy: two PROCESSES sharing an entity
#: name (sequential rados_cli runs) must not mint colliding reqids
#: either, or the OSDs' replicated dup logs treat the second process's
#: first mutation as a replay of the first's (exactly-once working
#: exactly as designed against accidentally-identical ids)
_INCARNATIONS = itertools.count(int.from_bytes(os.urandom(6), "big"))


def deliver_notify_event(messenger, name: str, callbacks: Dict, src: str,
                         msg: dict) -> None:
    """Run a watch callback as its own task, then ack the watch authority
    (shared by the Objecter and a standalone client-side ECBackend --
    librados semantics: notify completes when handlers have run)."""

    async def run_cb():
        cb = callbacks.get(msg["oid"])
        if cb is not None:
            try:
                res = cb(msg["oid"], msg.get("payload"))
                if asyncio.iscoroutine(res):
                    await res
            except Exception:  # noqa: BLE001 -- a watcher callback crash
                # must not lose the ack
                import traceback

                traceback.print_exc()
        await messenger.send_message(name, src, {
            "op": "notify_ack", "notify_id": msg["notify_id"],
            "watcher": name,
        })

    messenger.adopt_task(
        f"{name}.watchcb{msg['notify_id']}",
        asyncio.get_event_loop().create_task(run_cb()),
    )


class Objecter:
    """Routes each client op to the object's current primary OSD."""

    def __init__(
        self,
        messenger,
        km: int,
        n_osds: int,
        placement=None,
        name: str = "client",
        pool: str = "",
        op_timeout: float = 30.0,
        oid_prefix: str = "",
        qos_class: Optional[str] = None,
    ):
        self.messenger = messenger
        #: per-client QoS class (docs/qos.md): stamped on every op as
        #: ``qos_class`` so the primary's unified admission layer and
        #: mclock op queue schedule it under that class's
        #: reservation/weight/limit triple; None = the base "client"
        #: class (no field on the wire)
        self.qos_class = qos_class
        self.km = km
        self.n_osds = n_osds
        self.placement = placement
        self.name = name
        self.pool = pool
        self.op_timeout = op_timeout
        #: per-pool object namespace: co-hosted pools share each OSD's
        #: flat store, so without a distinct prefix two pools' shard
        #: objects for the same client oid would collide ("obj@1" from
        #: both) -- the reference scopes names by PG collection (spg_t
        #: embeds the pool id, src/osd/osd_types.h).  Empty for the
        #: first/only pool (legacy names).
        self.oid_prefix = oid_prefix
        self.perf = PerfCounters(name)
        #: client-side op tracking: every logical op is a TrackedOp
        #: whose span (when sampled) roots the cross-daemon trace --
        #: dump_ops_in_flight/dump_historic_ops work client-side too
        self.optracker = OpTracker(perf=self.perf, name=name)
        #: tid base: random 48-bit offset per Objecter.  Tids exist in
        #: replies, sub-op frames and the lossless replay queues of
        #: long-lived daemons; two client PROCESSES sharing an entity
        #: name (rados_cli invocations against one vstart cluster) both
        #: starting at tid 1 let a REPLAYED stale reply from the dead
        #: process's session match the live process's pending op -- the
        #: op was acked without ever executing (observed as rados_cli
        #: put "succeeding" with no sub-writes anywhere).  A random
        #: base makes cross-process tid collisions vanishingly rare.
        self._tid = int.from_bytes(os.urandom(6), "big")
        #: reqid incarnation (osd_reqid_t role): (name, inc, tid)
        #: identifies each logical op across any number of resends
        self.incarnation = next(_INCARNATIONS)
        self._pending: Dict[int, asyncio.Future] = {}
        #: tids whose primary this client demoted on failed probes; a
        #: late reply arriving for one proves the demotion false
        #: (observability: the false_demotion perf counter)
        self._demoted: set = set()
        #: per-OSD backoff gates: cleared when that OSD backs an op off,
        #: set again by its backoff_release (ops park on the event)
        self._backoff_gates: Dict[str, asyncio.Event] = {}
        #: oid -> callback for watch/notify events (events are sent by the
        #: watch authority OSD straight to this client)
        self._watch_callbacks: Dict[str, object] = {}
        #: optional monitor-traffic hook (command replies, map broadcasts)
        self.mon_hook = None
        messenger.register(name, self.dispatch)

    # -- placement (the _calc_target role) ---------------------------------

    def _acting_abs(self, oid_abs: str) -> List[Optional[int]]:
        """Placement of an already-namespaced oid."""
        oid_abs = oid_abs.split("~", 1)[0]  # clones place with their head
        if self.placement is not None:
            return self.placement.acting(oid_abs)
        from ceph_tpu_torch.osd.placement import fallback_acting

        return fallback_acting(oid_abs, self.n_osds, self.km)

    def acting_set(self, oid: str) -> List[Optional[int]]:
        return self._acting_abs(self.oid_prefix + oid)

    def _shard_up(self, acting, s: int) -> bool:
        return acting[s] is not None and not self.messenger.is_down(
            f"osd.{acting[s]}"
        )

    def _primary_abs(self, oid_abs: str) -> str:
        acting = self._acting_abs(oid_abs)
        for s in range(self.km):
            if self._shard_up(acting, s):
                return f"osd.{acting[s]}"
        raise IOError(f"no up OSD to serve {oid_abs}")

    def primary_of(self, oid: str) -> str:
        """The object's current primary: the first up shard of the acting
        set (the reference's primary is acting[0]; on its death a map
        change promotes the next shard)."""
        return self._primary_abs(self.oid_prefix + oid)

    # -- dispatch ----------------------------------------------------------

    async def dispatch(self, src: str, msg) -> None:
        if not isinstance(msg, dict):
            return
        op = msg.get("op")
        if op == "client_reply":
            fut = self._pending.get(msg.get("tid"))
            if fut is not None and not fut.done():
                fut.set_result(msg)
            elif msg.get("tid") in self._demoted:
                # the "dead" primary answered after all: the probe-driven
                # demotion was false (host load, not death) -- count it
                # so the grace/retry knobs can be tuned from telemetry
                self._demoted.discard(msg.get("tid"))
                self.perf.inc("false_demotion")
            return
        if op == "backoff":
            # RADOS PG backoff: the PG is peering; park the op until the
            # OSD's release.  clear-before-resolve ordering + per-conn
            # FIFO delivery make the later release visible even if it
            # is processed before the op task starts waiting.
            gate = self._backoff_gates.setdefault(src, asyncio.Event())
            gate.clear()
            self.perf.inc("backoff_received")
            fut = self._pending.get(msg.get("tid"))
            if fut is not None and not fut.done():
                fut.set_result(dict(msg, _backoff_from=src))
            return
        if op == "backoff_release":
            gate = self._backoff_gates.get(src)
            if gate is not None:
                gate.set()
            self.perf.inc("backoff_release_received")
            return
        if op == "notify_event":
            deliver_notify_event(
                self.messenger, self.name, self._watch_callbacks, src, msg
            )
            return
        if self.mon_hook is not None:
            await self.mon_hook(msg)

    # -- op submission with primary failover -------------------------------

    async def _probe(self, entity: str, timeout: float = 1.0) -> bool:
        probe = getattr(self.messenger, "probe", None)
        if probe is not None:
            try:
                return await probe(entity, timeout=timeout)
            except TypeError:
                return await probe(entity)
        return not self.messenger.is_down(entity)

    def _new_reqid(self) -> tuple:
        """Mint an osd_reqid_t: (client name, incarnation, tid).  One
        per LOGICAL op -- failover resends reuse it, which is what lets
        the OSDs' PG-log dup entries recognize the replay."""
        self._tid += 1
        return (self.name, self.incarnation, self._tid)

    async def _backoff_wait(self, osd: str, deadline: float) -> None:
        """Park until ``osd`` releases its PG backoff (or the deadline):
        the op resends the moment the PG goes active instead of polling
        probe slices against a peering primary."""
        gate = self._backoff_gates.setdefault(osd, asyncio.Event())
        remain = deadline - asyncio.get_event_loop().time()
        if remain <= 0:
            return
        try:
            # deadline-capped: a lost release (the OSD died while we
            # were parked) degrades to the normal failover path
            await asyncio.wait_for(gate.wait(), timeout=remain)
        except asyncio.TimeoutError:
            pass

    async def _submit(self, kind: str, oid: str, timeout: float = None,
                      **fields):
        """Send one op to the primary; fail over -- with exponential
        backoff plus jitter, under the op deadline -- to the next up
        shard if the primary becomes unreachable before replying.  Safe
        for every op kind: resends carry the op's reqid and a primary
        that already applied it answers from its PG log dups instead of
        re-executing."""
        from ceph_tpu_torch.utils.config import get_config

        oid = self.oid_prefix + oid  # enter the pool's namespace
        loop = asyncio.get_event_loop()
        deadline = loop.time() + (
            timeout if timeout is not None else self.op_timeout
        )
        cfg = get_config()
        backoff_base = float(cfg.get_val("client_backoff_base"))
        backoff_max = float(cfg.get_val("client_backoff_max"))
        conflict_retries = 1
        reqid = self._new_reqid()
        resends = 0
        # the trace ROOT: the sampling roll happens once, here, and the
        # decision travels with the op (unsampled ops carry no wire
        # context and cost nothing downstream)
        span = trace.new_trace(f"client:{kind}")
        op = self.optracker.create_request(f"{kind} {oid}", span=span)
        wire_ctx = span.to_wire() if span else None
        try:
            return await self._submit_tracked(
                kind, oid, fields, loop, deadline, cfg, backoff_base,
                backoff_max, conflict_retries, reqid, resends, op,
                wire_ctx)
        finally:
            op.finish()

    async def _submit_tracked(self, kind, oid, fields, loop, deadline,
                              cfg, backoff_base, backoff_max,
                              conflict_retries, reqid, resends, op,
                              wire_ctx):
        while True:
            with _PS_SUBMIT:
                self._tid += 1
                tid = self._tid
                fut = loop.create_future()
                self._pending[tid] = fut
                msg = dict(fields, op="client_op", tid=tid, kind=kind,
                           oid=oid, pool=self.pool, reqid=list(reqid))
                if self.qos_class is not None:
                    msg["qos_class"] = self.qos_class
                if wire_ctx is not None:
                    msg["trace"] = wire_ctx
            try:
                primary = self._primary_abs(oid)
                await self.messenger.send_message(self.name, primary, msg)
                op.mark_event("sent" if not resends else "resent")
                reply = await self._await_reply(fut, tid, primary, deadline)
                op.mark_event("reply_received")
            finally:
                self._pending.pop(tid, None)
            if reply is None:
                # primary unreachable: the messenger marked it down, so
                # primary_of() now promotes the next up shard.  Resend
                # the SAME reqid after a jittered exponential backoff --
                # an instant blind retry would hammer a cluster that is
                # mid-role-handoff (and every client would do it in
                # lockstep), while an unbounded wait would blow the op
                # deadline.
                self.perf.inc("primary_failover")
                remain = deadline - loop.time()
                if remain <= 0:
                    raise IOError(f"{kind} {oid}: op timed out")
                delay = min(backoff_max, backoff_base * (2 ** resends))
                delay *= 0.5 + random.random() * 0.5  # jitter
                await asyncio.sleep(min(delay, max(0.0, remain - 0.001)))
                resends += 1
                self.perf.inc("op_resend")
                continue
            if reply.get("op") == "backoff":
                # the PG is peering: park until its release, then resend
                # (same reqid) -- no probe slices, no blind retries
                await self._backoff_wait(
                    reply.get("_backoff_from", primary), deadline
                )
                if loop.time() >= deadline:
                    raise IOError(f"{kind} {oid}: op timed out in backoff")
                resends += 1
                self.perf.inc("op_resend")
                continue
            if reply["ok"]:
                self.perf.inc(kind)
                return reply.get("result")
            etype = reply.get("etype", "IOError")
            if etype == "WriteConflict" and conflict_retries > 0:
                # the engine learned the winning version from the refusal;
                # one replay lands on top of it (see ECBackend.write).
                # FRESH reqid: this is a new execution by design -- the
                # refused attempt's dup entries (shards that applied
                # before the conflict surfaced) must not answer it.
                conflict_retries -= 1
                reqid = self._new_reqid()
                self.perf.inc("write_conflict_retry")
                continue
            if (self._primary_abs(oid) != primary
                    or self.messenger.is_down(primary)):
                # the serving primary LOST its role mid-op (died, or the
                # map moved the object away): its error was computed
                # against a stale acting view and is not authoritative.
                # Re-dispatch to the current primary -- same reqid, so a
                # shard that already applied the op answers from its
                # dup entries (the reference resends in-flight ops on
                # every osdmap epoch change, Objecter::handle_osd_map).
                remain = deadline - loop.time()
                if remain > 0:
                    resends += 1
                    self.perf.inc("op_resend_stale_primary")
                    continue
            exc = _EXCEPTIONS.get(etype, IOError)
            raise exc(reply.get("error", f"{kind} {oid} failed"))

    async def _await_reply(self, fut, tid: int, primary: str,
                           deadline: float):
        """Wait for the reply in probe-sized slices; None when the primary
        is found dead (caller fails over).  Probe cadence is config-driven
        (client_probe_grace seconds per slice/probe, client_probe_retries
        consecutive failures to demote): one missed connect under host
        load must not demote a live primary -- the reference needs
        several missed heartbeats before an osd is reported failed
        (OSD.cc handle_osd_ping grace).  Demotions are remembered so a
        late reply increments the false_demotion counter."""
        from ceph_tpu_torch.utils.config import get_config

        cfg = get_config()
        grace = float(cfg.get_val("client_probe_grace"))
        retries = max(1, int(cfg.get_val("client_probe_retries")))
        loop = asyncio.get_event_loop()
        while True:
            remain = deadline - loop.time()
            if remain <= 0:
                return None
            try:
                return await asyncio.wait_for(
                    asyncio.shield(fut), timeout=min(grace, remain)
                )
            except asyncio.TimeoutError:
                if self.messenger.is_down(primary):
                    return None
                for _ in range(retries):
                    if await self._probe(primary, timeout=grace):
                        break
                else:
                    # every probe failed: demote.  Remember the tid so a
                    # reply that still arrives is counted as a false
                    # demotion (bounded: stale tids evicted FIFO-ish)
                    self._demoted.add(tid)
                    while len(self._demoted) > 256:
                        self._demoted.pop()
                    self.perf.inc("probe_demotion")
                    return None

    # -- vectorized submit -------------------------------------------------

    async def submit_many(self, ops, timeout: float = None,
                          return_exceptions: bool = False) -> list:
        """Batched submit: ``ops`` is a sequence of ``(kind, oid,
        fields)`` triples.  The whole batch is prepared under ONE
        ``objecter.submit`` stage crossing (reqids/tids minted, op
        dicts built, trace roots rolled) and handed to the messenger as
        ONE multi-destination ``send_messages`` call, so each primary's
        cork queue gathers this client's share of the batch into a
        single wire burst -- and the primary's dispatch loop drains it
        in one wakeup, handing the per-PG coalescer whole op batches
        instead of N interleaved singles.  Replies resolve
        concurrently.

        Failure semantics are IDENTICAL to N sequential ``_submit``
        calls: any op that cannot complete from its batch send
        (primary failover, PG backoff, write conflict) falls back to
        the per-op retry loop carrying its already-minted reqid, so
        the PG-log dup entries recognize resends exactly as before.
        Returns one result per op, in order; the first failed op's
        exception is raised after every op has settled (no sibling is
        cancelled mid-flight), or -- with ``return_exceptions`` -- each
        failure is returned in its slot (the loadgen accounting
        surface)."""
        from ceph_tpu_torch.utils.config import get_config

        loop = asyncio.get_event_loop()
        deadline = loop.time() + (
            timeout if timeout is not None else self.op_timeout
        )
        cfg = get_config()
        backoff_base = float(cfg.get_val("client_backoff_base"))
        backoff_max = float(cfg.get_val("client_backoff_max"))
        prepared = []
        pairs = []
        with _PS_SUBMIT:
            for kind, oid, fields in ops:
                oid_abs = self.oid_prefix + oid
                reqid = self._new_reqid()
                span = trace.new_trace(f"client:{kind}")
                op = self.optracker.create_request(
                    f"{kind} {oid_abs}", span=span)
                wire_ctx = span.to_wire() if span else None
                self._tid += 1
                tid = self._tid
                fut = loop.create_future()
                self._pending[tid] = fut
                msg = dict(fields, op="client_op", tid=tid, kind=kind,
                           oid=oid_abs, pool=self.pool, reqid=list(reqid))
                if self.qos_class is not None:
                    msg["qos_class"] = self.qos_class
                if wire_ctx is not None:
                    msg["trace"] = wire_ctx
                try:
                    primary = self._primary_abs(oid_abs)
                except IOError:
                    primary = None  # no up OSD now: the retry loop probes
                prepared.append((kind, oid_abs, fields, reqid, tid, fut,
                                 op, wire_ctx, primary))
                if primary is not None:
                    pairs.append((primary, msg))
        await self.messenger.send_messages(self.name, pairs)
        settled = await asyncio.gather(
            *(self._resolve_batched(p, loop, deadline, cfg, backoff_base,
                                    backoff_max) for p in prepared),
            return_exceptions=True,
        )
        if not return_exceptions:
            for r in settled:
                if isinstance(r, BaseException):
                    raise r
        return list(settled)

    async def _resolve_batched(self, p, loop, deadline, cfg,
                               backoff_base, backoff_max):
        """Await one batched op's reply; divert to the per-op retry
        machinery (same reqid) on failover/backoff/conflict."""
        kind, oid_abs, fields, reqid, tid, fut, op, wire_ctx, primary = p
        try:
            try:
                if primary is not None:
                    op.mark_event("sent")
                    reply = await self._await_reply(
                        fut, tid, primary, deadline)
                    if reply is not None:
                        op.mark_event("reply_received")
                else:
                    reply = None
            finally:
                self._pending.pop(tid, None)
            if reply is not None and reply.get("op") != "backoff":
                if reply["ok"]:
                    self.perf.inc(kind)
                    return reply.get("result")
                etype = reply.get("etype", "IOError")
                if etype == "WriteConflict":
                    # the refusal taught the engine the winning version;
                    # one replay under a FRESH reqid (the refused
                    # attempt's dups must not answer it), with no
                    # further conflict retries -- the _submit budget
                    self.perf.inc("write_conflict_retry")
                    return await self._submit_tracked(
                        kind, oid_abs, fields, loop, deadline, cfg,
                        backoff_base, backoff_max, 0, self._new_reqid(),
                        0, op, wire_ctx)
                exc = _EXCEPTIONS.get(etype, IOError)
                raise exc(reply.get("error", f"{kind} {oid_abs} failed"))
            if reply is None:
                # batch send never reached a live primary: jittered
                # backoff before the retry loop resends (same reqid),
                # exactly like a first _submit attempt failing over
                self.perf.inc("primary_failover")
                remain = deadline - loop.time()
                if remain <= 0:
                    raise IOError(f"{kind} {oid_abs}: op timed out")
                delay = backoff_base * (0.5 + random.random() * 0.5)
                await asyncio.sleep(
                    min(delay, max(0.0, remain - 0.001)))
            else:
                # PG backoff: park until the OSD's release, then let
                # the retry loop resend under the same reqid
                await self._backoff_wait(
                    reply.get("_backoff_from", primary), deadline)
                if loop.time() >= deadline:
                    raise IOError(
                        f"{kind} {oid_abs}: op timed out in backoff")
            self.perf.inc("op_resend")
            return await self._submit_tracked(
                kind, oid_abs, fields, loop, deadline, cfg,
                backoff_base, backoff_max, 1, reqid, 1, op, wire_ctx)
        finally:
            op.finish()

    async def write_many(self, items, snapc=None) -> None:
        """Batched ``write``: ``items`` is an iterable of ``(oid,
        data)`` pairs -- one submit_many stage crossing, one wire burst
        per primary."""
        await self.submit_many([
            ("write", oid, {"data": bytes(data), "snapc": snapc})
            for oid, data in items
        ])

    async def read_many(self, oids, snap=None) -> List[bytes]:
        """Batched ``read``: results in ``oids`` order."""
        return await self.submit_many([
            ("read", oid, {"snap": snap}) for oid in oids
        ])

    # -- I/O surface (librados IoCtx ops, one round trip each) -------------

    async def write(self, oid: str, data: bytes, snapc=None) -> None:
        await self._submit("write", oid, data=bytes(data), snapc=snapc)

    async def read(self, oid: str, snap=None) -> bytes:
        return await self._submit("read", oid, snap=snap)

    async def write_range(self, oid: str, offset: int, data: bytes,
                          snapc=None) -> None:
        await self._submit("write_range", oid, offset=offset,
                           data=bytes(data), snapc=snapc)

    async def read_range(self, oid: str, offset: int, length: int,
                         snap=None) -> bytes:
        return await self._submit("read_range", oid, offset=offset,
                                  length=length, snap=snap)

    async def remove_object(self, oid: str, snapc=None) -> None:
        await self._submit("remove", oid, snapc=snapc)

    # -- snapshots (librados selfmanaged snap surface) ---------------------

    async def snap_rollback(self, oid: str, snapid: int, snapc=None) -> None:
        await self._submit("snap_rollback", oid, snapid=snapid, snapc=snapc)

    async def snap_trim(self, oid: str, live_snaps) -> int:
        return await self._submit("snap_trim", oid,
                                  live_snaps=list(live_snaps))

    async def list_snaps(self, oid: str) -> dict:
        return await self._submit("list_snaps", oid)

    async def stat(self, oid: str):
        """(logical size, hinfo dict | None) from the primary."""
        size, hinfo = await self._submit("stat", oid)
        return size, hinfo

    async def deep_scrub(self, oid: str) -> dict:
        return await self._submit("scrub", oid)

    async def recover_shard(self, oid: str, shard: int,
                            target_osd: int) -> None:
        await self._submit("recover", oid, shard=shard, target=target_osd)

    # -- metadata plane ----------------------------------------------------

    async def omap_set(self, oid: str, kvs: Dict[str, bytes]) -> None:
        await self._submit("omap_set", oid, kvs=dict(kvs))

    async def omap_get(self, oid: str, keys=None) -> Dict[str, bytes]:
        return await self._submit(
            "omap_get", oid, keys=list(keys) if keys is not None else None
        )

    async def omap_rm(self, oid: str, keys) -> None:
        await self._submit("omap_rm", oid, keys=list(keys))

    async def omap_clear(self, oid: str) -> None:
        await self._submit("omap_clear", oid)

    async def omap_cas(self, oid: str, key: str, expect, new):
        ok, cur = await self._submit(
            "omap_cas", oid, key=key, expect=expect, new=new
        )
        return ok, cur

    async def exec(self, oid: str, cls: str, method: str, inp: bytes = b""):
        ret, out = await self._submit(
            "exec", oid, cls=cls, method=method, inp=bytes(inp)
        )
        return ret, out

    async def watch(self, oid: str, callback) -> None:
        # callbacks key on the namespaced oid (notify events carry the
        # engine's name) but are INVOKED with the oid the caller
        # registered -- the namespace is this Objecter's private affair
        if self.oid_prefix and callback is not None:
            orig, prefix = callback, self.oid_prefix

            def callback(o, payload, _cb=orig, _p=prefix):
                return _cb(o[len(_p):] if o.startswith(_p) else o, payload)

        self._watch_callbacks[self.oid_prefix + oid] = callback
        try:
            await self._submit("watch", oid, watcher=self.name)
        except Exception:
            self._watch_callbacks.pop(self.oid_prefix + oid, None)
            raise

    async def unwatch(self, oid: str) -> None:
        self._watch_callbacks.pop(self.oid_prefix + oid, None)
        await self._submit("unwatch", oid, watcher=self.name)

    async def notify(self, oid: str, payload=None, timeout: float = 5.0):
        return await self._submit(
            "notify", oid, payload=payload,
            timeout_ms=int(timeout * 1000),
            # the authority gathers acks for up to ``timeout``; give the
            # round trip headroom past that
            timeout=timeout + 4.0,
        )
