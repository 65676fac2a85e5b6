"""Batched background data plane: recovery coalescing + scrub cursors.

Port of ``ceph_tpu/osd/recovery.py``.

The CLIENT write lane is batched (per-PG coalescer), corked
(multi-submit messenger bursts) and device-resident; without this
module, background data movement -- recovery pushes, backfill,
deep-scrub reads -- would flow one object, one message at a time.
Online-EC studies show recovery I/O dominates degraded-mode cost
(arXiv "Understanding System Characteristics of Online Erasure
Coding...", "Exploring Fault-Tolerant Erasure Codes..."), so a rebuild
storm was both slow AND able to starve client p99.

This module routes background movement through the same batched
shard-major plane the client path uses:

* **RecoveryCoalescer** -- groups a peering pass's missing objects into
  batches: ONE corked multi-read burst gathers every batch object's
  source chunks (one ``ECSubRead`` per (source OSD, shard position)
  covering all its objects), one fused ``decode_shards_many`` dispatch
  reconstructs every lost shard (signature-grouped, riding the
  rung-bucketed pipeline), and ONE corked multi-push burst
  ships the rebuilt shards (``ECSubWrite`` op_class="recovery").
  Objects the batch cannot prove consistent (version races, oversized
  shards past the per-object byte share) fall back to the per-object
  windowed path -- correctness never rides the fast lane.
* **promote-on-recovery** -- a rebuilt hot (or previously-resident)
  object's FULL [km, shard_len] block is already in hand after the
  fused decode; in writeback mode it lands straight in the device tier
  (``tier_promote_from_recovery``), so the rebuilt object serves its
  next read from HBM instead of going cold and waiting for the agent
  to re-gather it from the shards it was just pushed to.
* **BackgroundThrottle** -- every batch is admitted against an active
  budget (``osd_recovery_max_active`` concurrent batches,
  ``osd_recovery_batch_bytes`` gathered bytes each) and backs off while
  the hosting OSD's client queue is saturated (``recovery_preempted``),
  with bounded preemption so degraded objects that BLOCK client ops
  still make forced progress; ``osd_recovery_sleep`` paces between
  batches.  Receiving OSDs additionally queue every sub-op under the
  mClock/WPQ ``recovery``/``scrub`` op classes as before.
* **scrub_read_many** -- deep scrub's reads ride the same batched lane
  with a chunked cursor (``osd_scrub_chunk_max`` bytes per shard per
  round, ``scrub_chunks`` counted), instead of one whole-shard read
  fan-out per object.

cephlint's ``async-background-unthrottled`` rule pins the discipline:
a background-class loop issuing pushes/reads must admit through the
throttle or await pacing between batches.
"""

from __future__ import annotations

import asyncio
from typing import Dict, List, Optional, Tuple

import numpy as np

from ceph_tpu_torch.ops.pipeline import uncached_uploads
from ceph_tpu_torch.osd import ecutil
from ceph_tpu_torch.osd.pg import (SIZE_KEY, SNAPSET_KEY, VERSION_KEY,
                             WHITEOUT_KEY, shard_oid, vt)
from ceph_tpu_torch.osd.types import ECSubRead, ECSubWrite, Transaction
from ceph_tpu_torch.utils import trace

#: queued client ops above which background batches back off (the
#: saturation signal; _cop_sem bounds execution at 64, so half a
#: worker's width of queued-but-unserved clients means contention)
CLIENT_PRESSURE_OPS = 16
#: preemption rounds before a batch is forced through anyway: a
#: degraded object can BLOCK the very client ops saturating the queue
#: (reads needing the missing shard), so recovery must never be
#: starved forever by the load it exists to unblock
MAX_PREEMPT_ROUNDS = 20
#: objects per batched dispatch (the byte budget is the real bound;
#: this caps the per-batch fan-out bookkeeping)
MAX_BATCH_OBJECTS = 32


def _cfg():
    from ceph_tpu_torch.utils.config import get_config

    return get_config()


class BackgroundThrottle:
    """Primary-side admission for background batches (recovery, scrub).

    Bounds concurrent batches (``osd_recovery_max_active``) and backs
    off while the hosting OSD's client queue is saturated; preemption
    is bounded (forced progress) and every backoff round is counted
    (``recovery_preempted``)."""

    def __init__(self, backend):
        self._backend = backend
        self._sem: Optional[asyncio.Semaphore] = None
        self._sem_width = 0
        #: unified-QoS slots currently held (admit/release pairing is
        #: caller-side positional, and every slot is the same
        #: "recovery"-class token, so a simple count suffices)
        self._qos_held = 0

    def _semaphore(self) -> asyncio.Semaphore:
        width = max(1, int(_cfg().get_val("osd_recovery_max_active")))
        if self._sem is None or width != self._sem_width:
            self._sem = asyncio.Semaphore(width)
            self._sem_width = width
        return self._sem

    def _qos(self):
        """The hosting shard's unified admission (osd/qos.py), when the
        engine is shard-hosted and osd_qos_unified is on."""
        shard = getattr(self._backend, "_host_shard", None)
        return getattr(shard, "qos", None)

    def _client_pressure(self) -> bool:
        shard = getattr(self._backend, "_host_shard", None)
        if shard is None:
            return False
        return getattr(shard, "_client_ops_queued", 0) > CLIENT_PRESSURE_OPS

    async def admit(self, force: bool = False, cost: int = 0) -> None:
        """Claim one background-batch slot.  Under unified QoS the
        claim is a dmClock "recovery"-class admission (osd/qos.py) with
        ``cost`` = the batch's byte budget: client bursts win the freed
        slots by weight, recovery's reservation guarantees forward
        progress -- replacing the legacy client-pressure gauge loop,
        which remains the fallback (osd_qos_unified=false, client-side
        engines) with its bounded preemption."""
        await self._semaphore().acquire()
        qos = self._qos()
        if qos is not None:
            try:
                held = await qos.acquire("recovery", max(1, int(cost)))
            except BaseException:
                self._sem.release()
                raise
            if held:
                self._qos_held += 1
            return
        rounds = 0
        while not force and rounds < MAX_PREEMPT_ROUNDS \
                and self._client_pressure():
            self._backend.perf.inc("recovery_preempted")
            rounds += 1
            await asyncio.sleep(max(
                0.005, float(_cfg().get_val("osd_recovery_sleep"))))

    def release(self) -> None:
        if self._qos_held > 0:
            qos = self._qos()
            if qos is not None:
                self._qos_held -= 1
                qos.release_slot()
        if self._sem is not None:
            self._sem.release()

    async def pace(self) -> None:
        """Awaited pacing between batches (osd_recovery_sleep; 0 still
        yields once so queued client ops interleave)."""
        await asyncio.sleep(float(_cfg().get_val("osd_recovery_sleep")))


# -- batched sub-op transport helpers ------------------------------------
#
# One pending-state entry per message, ONE send_messages submit for the
# whole set: the TCP messenger's per-peer cork queues gather each peer's
# share into a single scatter-gather burst (the PR-3 corked wire,
# previously reserved for client fan-outs).

async def batched_sub_reads(
    backend,
    reads: List[tuple],
    op_class: str,
    timeout: float,
) -> List[Optional[object]]:
    """``reads``: (osd_name, from_shard, {oid: extents}, attrs_to_read
    [, regen]) per message -- the optional 5th element is the
    regenerating-repair coefficient map ({oid: phi_f}) carried on the
    ECSubRead wire field.  Returns one ECSubReadReply (or None on
    loss/timeout) per entry, in order."""
    loop = asyncio.get_event_loop()
    wire_ctx = trace.current_wire()  # stitch into the batch span
    pend = []
    subs = []
    for entry in reads:
        osd_name, s, to_read, attrs = entry[:4]
        regen = entry[4] if len(entry) > 4 else None
        tid = backend._new_tid()
        done = loop.create_future()
        backend._pending[tid] = {
            "replies": {}, "outstanding": {s}, "done": done,
        }
        pend.append((tid, s, done))
        subs.append((osd_name, ECSubRead(
            from_shard=s, tid=tid,
            to_read={oid: list(ext) for oid, ext in to_read.items()},
            attrs_to_read=list(attrs), op_class=op_class,
            trace=wire_ctx, regen=regen,
        )))
    await backend.messenger.send_messages(backend.name, subs)
    if pend:
        try:
            await asyncio.wait_for(
                asyncio.gather(*(d for _t, _s, d in pend)), timeout)
        except asyncio.TimeoutError:
            pass  # missing replies surface as None below
    out = []
    for tid, s, _done in pend:
        state = backend._pending.pop(tid, None)
        out.append(state["replies"].get(s) if state else None)
    return out


async def batched_pushes(
    backend,
    pushes: List[Tuple[str, ECSubWrite]],
    timeout: float,
) -> List[bool]:
    """Ship every (target osd, sub-write) as ONE corked multi-submit
    burst; returns per-push commit success, in order."""
    loop = asyncio.get_event_loop()
    wire_ctx = trace.current_wire()  # stitch into the batch span
    pend = []
    for target, _sub in pushes:
        if wire_ctx is not None and getattr(_sub, "trace", None) is None:
            _sub.trace = wire_ctx
        done = loop.create_future()
        backend._pending[_sub.tid] = {
            "committed": set(), "expected": {target}, "done": done,
        }
        pend.append((_sub.tid, done))
    await backend.messenger.send_messages(backend.name, pushes)
    if pend:
        try:
            # return_exceptions: one refused push must not abandon the
            # rest of the burst's accounting
            await asyncio.wait_for(
                asyncio.gather(*(d for _t, d in pend),
                               return_exceptions=True), timeout)
        except asyncio.TimeoutError:
            pass
    out = []
    for tid, done in pend:
        state = backend._pending.pop(tid, None)
        ok = bool(state and state["committed"])
        if done.done() and not done.cancelled() and \
                done.exception() is not None:
            ok = False
        out.append(ok)
    return out


# -- the recovery coalescer ----------------------------------------------

class RecoveryCoalescer:
    """Per-PG batched recovery driver (the background analogue of the
    client-op BatchCoalescer).  Owned lazily by the PG engine; all
    state is per-call, so concurrent peering passes just share the
    throttle."""

    def __init__(self, backend):
        self.backend = backend
        self.throttle = BackgroundThrottle(backend)

    # -- entry point from the peering pass --------------------------------

    async def recover_actions(self, actions: List[tuple]) -> set:
        """Run a peering pass's recovery actions (oid, shard, target,
        authoritative, rollback) through the batched plane; returns the
        oids whose recovery failed (kept dirty for the next pass)."""
        backend = self.backend
        failed: set = set()
        plain: Dict[str, List[tuple]] = {}
        for oid, s, target, authoritative, rb in actions:
            if rb and await backend._try_log_rollback(
                oid, s, target, authoritative
            ):
                continue  # the shard healed itself from its own log
            if tuple(authoritative) == (0, ""):
                # torn copy with no assemblable object behind it: the
                # rollback target is non-existence (rare; per-object)
                try:
                    await backend._remove_shard_copy(oid, s, target)
                except asyncio.CancelledError:
                    raise
                except Exception:  # noqa: BLE001 -- retried next pass
                    backend.perf.inc("recover_failed")
                    failed.add(oid)
                continue
            plain.setdefault(oid, []).append((s, target, rb))

        batch_cost = max(1, int(_cfg().get_val("osd_recovery_batch_bytes")))
        oids = sorted(plain)
        for i in range(0, len(oids), MAX_BATCH_OBJECTS):
            group = {oid: plain[oid] for oid in oids[i:i + MAX_BATCH_OBJECTS]}
            await self.throttle.admit(cost=batch_cost)
            try:
                fell_back = await self._recover_batch(group)
            finally:
                self.throttle.release()
            # objects the batch could not prove consistent (version
            # races, oversized shards, too few sources) take the
            # windowed per-object path -- correctness over speed
            for oid in fell_back:
                for s, target, rb in group[oid]:
                    try:
                        await backend.recover_shard(
                            oid, s, target, rollback=rb)
                    except asyncio.CancelledError:
                        raise
                    except Exception:  # noqa: BLE001 -- next pass retries
                        backend.perf.inc("recover_failed")
                        failed.add(oid)
            # per-group completion tick: the incremental degraded count
            # (pg_stats) drains as each batch lands, not at pass end --
            # what makes the chaos gate's drain curve monotone
            for oid in group:
                if oid not in failed:
                    backend.pg_stats.note_recovered(oid)
            await self.throttle.pace()
        return failed

    # -- one batch ---------------------------------------------------------

    async def _recover_batch(self, group: Dict[str, List[tuple]]) -> set:
        """Gather + fused rebuild + corked push for one object group;
        returns oids that must fall back to the per-object path.  Holds
        every batch object's write lock (sorted acquisition order) so
        client writes queue briefly behind the push instead of racing
        it -- the same pinning recover_shard does, batch-wide."""
        from contextlib import AsyncExitStack

        backend = self.backend
        # one batch span for the whole multi-read/decode/multi-push
        # cycle (background root: rolls its own sampling decision);
        # amortized over the batch's objects like a coalescer fan-in
        span = trace.new_trace("recovery_batch")
        if span.sampled:
            span.amortized_over = max(1, len(group))
            span.tag_set("objects", len(group))
        try:
            with trace.use_span(span):
                async with AsyncExitStack() as stack:
                    for oid in sorted(group):
                        await stack.enter_async_context(
                            backend._object_lock(oid))
                    span.event("locks_acquired")
                    return await self._recover_batch_locked(group)
        finally:
            span.finish()

    async def _recover_batch_locked(self,
                                    group: Dict[str, List[tuple]]) -> set:
        backend = self.backend
        cfg = _cfg()
        fall_back: set = set()
        # per-object source plan: chunk window sized so the whole
        # batch's gathered bytes stay under osd_recovery_batch_bytes
        batch_bytes = max(1, int(cfg.get_val("osd_recovery_batch_bytes")))
        cs = backend.sinfo.chunk_size
        share = batch_bytes // max(1, len(group)) // max(1, backend.k)
        win = max(cs, share // cs * cs)

        # sub-chunk geometry: every codec's minimum_to_decode speaks
        # (offset, count) plans over get_sub_chunk_count() sub-chunks;
        # converting them to byte extents here means a fractional plan
        # (regenerating codes, future Clay-style codecs) gathers ONLY
        # the bytes the fused decode consumes
        scc = max(1, int(getattr(backend.ec, "get_sub_chunk_count",
                                 lambda: 1)()))
        sub_bytes = win // scc if win % scc == 0 else 0

        plans: Dict[str, dict] = {}
        reads: Dict[Tuple[str, int], Dict[str, list]] = {}
        attr_reads: Dict[Tuple[str, int], Dict[str, list]] = {}
        regen_maps: Dict[Tuple[str, int], Dict[str, list]] = {}
        for oid, jobs in group.items():
            acting = backend.acting_set(oid)
            want = sorted({s for s, _t, _rb in jobs})
            up = [
                s for s in range(backend.km)
                if s not in want and backend._shard_up(acting, s)
            ]
            try:
                mtd = backend.ec.minimum_to_decode(list(want), up)
            except Exception:  # noqa: BLE001 -- unassemblable right now
                fall_back.add(oid)
                continue
            src = sorted(mtd.keys())
            plans[oid] = {"acting": acting, "want": want, "src": src}
            # regenerating-repair lane: the codec advertises fractional
            # repair AND handed back a sub-chunk plan strictly below a
            # whole shard per helper -- the gather carries phi_f and the
            # survivors reply beta-sized helper symbols (d * chunk/alpha
            # bytes on the wire instead of k whole chunks)
            fractional = (
                bool(getattr(backend.ec, "fractional_repair", False))
                and bool(cfg.get_val("osd_ec_fractional_repair"))
                and len(want) == 1 and sub_bytes > 0
                and all(sum(ln for _o, ln in ext) < scc
                        for ext in mtd.values())
                and not self._want_promote(oid, 1)
            )
            if fractional:
                lost = want[0]
                coeffs = backend.ec.repair_coeffs(lost)
                plans[oid]["regen"] = {"lost": lost, "helpers": src,
                                       "coeffs": coeffs}
                for s in src:
                    key = (f"osd.{acting[s]}", s)
                    reads.setdefault(key, {})[oid] = [(0, sub_bytes)]
                    regen_maps.setdefault(key, {})[oid] = coeffs
            else:
                for s in src:
                    key = (f"osd.{acting[s]}", s)
                    ext = mtd.get(s) or [(0, scc)]
                    reads.setdefault(key, {})[oid] = [
                        (off * sub_bytes, ln * sub_bytes)
                        for off, ln in ext
                    ] if sub_bytes and scc > 1 else [(0, win)]
            for s in up:
                if s in src:
                    continue
                # attr-only round from the remaining up shards: the
                # minimum source set alone cannot prove the
                # authoritative version (same rule as _gather_consistent)
                key = (f"osd.{acting[s]}", s)
                attr_reads.setdefault(key, {})[oid] = [(0, 0)]

        read_list = [
            (osd, s, to_read, sorted(to_read), regen_maps.get((osd, s)))
            for (osd, s), to_read in list(reads.items())
            + list(attr_reads.items())
        ]
        timeout = float(cfg.get_val("osd_read_gather_timeout"))
        replies = await batched_sub_reads(
            backend, read_list, "recovery", timeout)
        trace.event("gather_done")

        # collate per (oid, shard): chunks / helpers / versions / sizes
        per_oid: Dict[str, dict] = {
            oid: {"chunks": {}, "helpers": {}, "versions": {},
                  "sizes": {}, "attrs": {}}
            for oid in plans
        }
        gather_bytes = 0
        for (osd, s, to_read, _attrs, regen), reply in zip(
                read_list, replies):
            if reply is None:
                continue
            for oid in to_read:
                if oid not in per_oid or oid in reply.errors:
                    continue
                slot = per_oid[oid]
                bufs = reply.buffers_read.get(oid)
                if bufs and len(bufs[0][1]):
                    gather_bytes += sum(len(b) for _off, b in bufs)
                    arr = np.frombuffer(bufs[0][1], dtype=np.uint8)
                    if regen and oid in regen:
                        # beta-sized helper symbol, not shard bytes
                        slot["helpers"][s] = arr
                    else:
                        slot["chunks"][s] = arr
                attrs = reply.attrs_read.get(oid) or {}
                if attrs:
                    slot["attrs"][s] = attrs
                    if attrs.get(SIZE_KEY) is not None:
                        slot["sizes"][s] = attrs[SIZE_KEY]
                    slot["versions"][s] = vt(attrs.get(VERSION_KEY))

        if gather_bytes:
            backend.perf.inc("recovery_gather_bytes", gather_bytes)

        # -- per-object consistency election, then ONE fused decode ------
        maps: List[Dict[int, np.ndarray]] = []
        wants: List[List[int]] = []
        ready: List[str] = []
        regen_groups: Dict[tuple, List[str]] = {}
        for oid, plan in plans.items():
            slot = per_oid[oid]
            if not slot["versions"]:
                fall_back.add(oid)
                continue
            rg = plan.get("regen")
            if rg is not None:
                geom = self._elect_regen(plan, slot, win)
                if geom is None:
                    # stale/short/missing helper: the classic
                    # full-gather path re-runs this object
                    fall_back.add(oid)
                elif geom[0]:
                    key = (rg["lost"], tuple(rg["helpers"]), geom[1])
                    regen_groups.setdefault(key, []).append(oid)
                # chunk_total == 0 rides the attrs-only push below
                continue
            target_v = max(slot["versions"].values())
            holders = [s for s, v in slot["versions"].items()
                       if v == target_v]
            have = {s: slot["chunks"][s] for s in holders
                    if s in slot["chunks"]}
            size = next((slot["sizes"][s] for s in holders
                         if slot["sizes"].get(s) is not None), None)
            zero_len = size == 0 and not have
            if size is None or (len(have) < backend.k and not zero_len):
                # stale mix / missing size / newest version not
                # assemblable from this cut: the windowed path's full
                # version-authoritative gather decides
                fall_back.add(oid)
                continue
            chunk_total = backend._shard_bytes_total(size)
            if have and len(next(iter(have.values()))) < chunk_total:
                # object larger than the batch's per-object window:
                # recover it windowed (bounded batch memory)
                fall_back.add(oid)
                continue
            plan["version"] = target_v
            plan["size"] = size
            plan["chunk_total"] = chunk_total
            plan["attrs"] = next(
                (slot["attrs"][s] for s in holders if s in slot["attrs"]),
                {},
            )
            plan["have"] = have
            if chunk_total:
                # promote-on-recovery wants the FULL km block; the
                # fused dispatch reconstructs every missing position in
                # the same pass when the tier will take it
                missing = [s for s in range(backend.km) if s not in have]
                rebuild = missing if self._want_promote(oid, size) \
                    else sorted(set(plan["want"]) - set(have))
                maps.append(dict(have))
                wants.append(rebuild)
                ready.append(oid)
        if maps:
            trace.event("decode_submit")
            with uncached_uploads():
                decoded = ecutil.decode_shards_many(backend.ec, maps, wants)
            trace.event("decode_done")
        else:
            decoded = []

        # -- fused regenerating dispatch ---------------------------------
        # one device matmul per (lost shard, helper set, beta) signature:
        # the d stacked helper symbols of EVERY object in the group ride
        # a single batched repair-matrix apply
        for (lost, helpers, beta), g_oids in regen_groups.items():
            stacks = [
                np.stack([per_oid[o]["helpers"][s] for s in helpers])
                for o in g_oids
            ]
            try:
                regenerated = backend.ec.regenerate_batch(
                    lost, list(helpers), stacks)
            except Exception:  # noqa: BLE001 -- refuse -> full gather
                fall_back.update(g_oids)
                continue
            for o, shard in zip(g_oids, regenerated):
                ready.append(o)
                decoded.append({lost: shard})
                # classic repair reads k whole chunks; this one read
                # d beta-sized helper symbols
                plans[o]["bytes_saved"] = (
                    backend.k * plans[o]["chunk_total"]
                    - len(helpers) * beta)
        if regen_groups:
            trace.event("regen_done")

        # -- corked multi-push burst --------------------------------------
        pushes: List[Tuple[str, ECSubWrite]] = []
        push_oids: List[str] = []
        full: Dict[str, Dict[int, np.ndarray]] = {}
        for oid, rebuilt in zip(ready, decoded):
            plan = plans[oid]
            chunks = dict(plan["have"])
            chunks.update(rebuilt)
            full[oid] = chunks
            for s, target, rb in group[oid]:
                piece = chunks[s].tobytes() if plan["chunk_total"] else b""
                pushes.append((f"osd.{target}", self._push_sub(
                    oid, s, piece, plan, rb)))
                push_oids.append(oid)
        for oid in plans:
            if oid not in ready and oid not in fall_back \
                    and plans[oid].get("chunk_total") == 0:
                # zero-byte object: attrs-only push, no codec involved
                plan = plans[oid]
                for s, target, rb in group[oid]:
                    pushes.append((f"osd.{target}", self._push_sub(
                        oid, s, b"", plan, rb)))
                    push_oids.append(oid)
                full[oid] = {}
        commit_t = float(cfg.get_val("osd_client_op_commit_timeout"))
        results = await batched_pushes(backend, pushes, commit_t)
        trace.event("push_done")

        ok_oids: set = set()
        bad_oids: set = set()
        nbytes = 0
        backfill_bytes = 0
        misplaced = backend.pg_stats.misplaced
        for oid, (target, sub), ok in zip(push_oids, pushes, results):
            if ok:
                ok_oids.add(oid)
                for top in sub.transaction.ops:
                    if top.op == "write":
                        nbytes += len(top.data)
                        if oid in misplaced:
                            # migration (not rebuild) traffic: the copy
                            # exists elsewhere, it's just mis-placed --
                            # feeds the data-moved-ratio elasticity gate
                            backfill_bytes += len(top.data)
            else:
                bad_oids.add(oid)
        ok_oids -= bad_oids
        fall_back |= bad_oids
        if ok_oids:
            backend.perf.inc("recovery_ops_batched", len(ok_oids))
            backend.perf.inc("recovery_batches")
            backend.perf.inc("recover", len(ok_oids))
        if nbytes:
            backend.perf.inc("recovery_bytes", nbytes)
        if backfill_bytes:
            backend.perf.inc("recovery_backfill_bytes", backfill_bytes)
        saved = sum(plans[o].get("bytes_saved", 0)
                    for o in ok_oids if o in plans)
        if saved > 0:
            backend.perf.inc("recovery_bytes_saved", saved)

        # -- promote-on-recovery ------------------------------------------
        for oid in sorted(ok_oids):
            plan = plans.get(oid)
            if plan is None or not plan.get("chunk_total"):
                continue
            chunks = full.get(oid)
            if chunks and len(chunks) == backend.km and \
                    self._want_promote(oid, plan["size"]):
                block = np.stack([
                    np.asarray(chunks[s], dtype=np.uint8)
                    for s in range(backend.km)
                ])
                backend._tier.put(
                    backend.pool_name, oid, block, plan["version"],
                    plan["size"], dirty=False, promote_from_recovery=True,
                )
        return fall_back

    def _elect_regen(self, plan: dict, slot: dict, win: int):
        """Consistency election for one regenerating-repair object: ALL
        d planned helpers must have answered at the authoritative
        version with helper symbols spanning the FULL stored shard
        (beta * alpha == chunk_total).  Returns (chunk_total, beta) or
        None -- None sends the object back through the classic
        full-gather path, never a partial regeneration."""
        backend = self.backend
        rg = plan["regen"]
        target_v = max(slot["versions"].values())
        holders = {s for s, v in slot["versions"].items()
                   if v == target_v}
        size = next((slot["sizes"][s] for s in sorted(holders)
                     if slot["sizes"].get(s) is not None), None)
        if size is None:
            return None
        plan["version"] = target_v
        plan["size"] = size
        plan["attrs"] = next(
            (slot["attrs"][s] for s in sorted(holders)
             if s in slot["attrs"]), {})
        chunk_total = backend._shard_bytes_total(size)
        plan["chunk_total"] = chunk_total
        plan["have"] = {}
        if chunk_total == 0:
            return (0, 0)
        alpha = max(1, int(getattr(backend.ec, "alpha", 1)))
        if chunk_total % alpha or chunk_total > win:
            return None
        beta = chunk_total // alpha
        hs = slot["helpers"]
        if any(s not in holders or s not in hs or len(hs[s]) != beta
               for s in rg["helpers"]):
            return None
        return (chunk_total, beta)

    def _want_promote(self, oid: str, logical: int) -> bool:
        """Promote-on-recovery predicate: writeback tier, toggle on,
        and the object is hot or was resident (mirrors the write lane's
        ``_want_resident``)."""
        backend = self.backend
        if not logical or backend._tier is None or \
                backend.tier_mode != "writeback":
            return False
        if not bool(_cfg().get_val("osd_tier_promote_on_recovery")):
            return False
        return backend._tier.contains(backend.pool_name, oid) or \
            backend._tier_hot(oid)

    def _push_sub(self, oid: str, s: int, piece: bytes, plan: dict,
                  rollback: bool) -> ECSubWrite:
        """Full-shard recovery push transaction: bytes + truncate +
        the authoritative attr re-stamp (version, size, hinfo, snapset,
        whiteout, pool tag) -- the single-window analogue of the
        windowed path's final window."""
        backend = self.backend
        soid = shard_oid(oid, s)
        attrs = plan["attrs"] or {}
        txn = Transaction().write(soid, 0, piece)
        txn = backend._pool_stamp(
            txn.truncate(soid, plan["chunk_total"])
            .setattr(soid, ecutil.HINFO_KEY, attrs.get(ecutil.HINFO_KEY))
            .setattr(soid, SIZE_KEY, plan["size"])
            .setattr(soid, VERSION_KEY, plan["version"])
            .setattr(soid, SNAPSET_KEY, attrs.get(SNAPSET_KEY))
            .setattr(soid, WHITEOUT_KEY, attrs.get(WHITEOUT_KEY)),
            soid,
        )
        return ECSubWrite(
            from_shard=s, tid=backend._new_tid(), oid=oid,
            transaction=txn, at_version=plan["version"],
            op_class="recovery", rollback=rollback,
        )


# -- batched deep-scrub reads (chunked cursor) ---------------------------

async def scrub_read_many(
    backend, oids: List[str],
) -> Dict[str, Dict[int, dict]]:
    """Chunked, batched deep-scrub read of many objects: each round
    reads ``osd_scrub_chunk_max`` bytes per shard for every object
    still in progress as ONE corked multi-read burst (op_class
    "scrub"), so a scrub slice costs one burst per round instead of one
    whole-shard fan-out per object.

    Returns {oid: {shard: {"data": bytes|None, "attrs": dict,
    "error": int|None}}} over every up shard (shards whose OSD never
    answered are absent -- the caller classifies them missing)."""
    cfg = _cfg()
    chunk_max = max(backend.sinfo.chunk_size,
                    int(cfg.get_val("osd_scrub_chunk_max")))
    chunk_max = chunk_max // backend.sinfo.chunk_size * \
        backend.sinfo.chunk_size
    timeout = float(cfg.get_val("osd_read_gather_timeout"))
    state: Dict[str, Dict[int, dict]] = {}
    plans: Dict[str, dict] = {}
    for oid in oids:
        acting = backend.acting_set(oid)
        up = [s for s in range(backend.km)
              if backend._shard_up(acting, s)]
        plans[oid] = {"acting": acting, "up": up, "off": 0,
                      "total": None}
        state[oid] = {}

    throttle = backend._recovery().throttle
    pending = set(plans)
    first = True
    while pending:
        reads: Dict[Tuple[str, int], Dict[str, list]] = {}
        attr_want: Dict[Tuple[str, int], List[str]] = {}
        for oid in sorted(pending):
            plan = plans[oid]
            for s in plan["up"]:
                key = (f"osd.{plan['acting'][s]}", s)
                reads.setdefault(key, {})[oid] = [
                    (plan["off"], chunk_max)]
                attr_want.setdefault(key, []).append(oid)
        read_list = [
            (osd, s, to_read, attr_want[(osd, s)])
            for (osd, s), to_read in reads.items()
        ]
        qos = getattr(getattr(backend, "_host_shard", None), "qos", None)
        if qos is not None:
            # unified admission, transient form: the scrub round is
            # tag-ordered (and limit-paced) against client/recovery
            # classes but occupies no slot across its reads -- the
            # chunk cursor already bounds its footprint
            await qos.admit(
                "scrub", chunk_max * max(1, sum(
                    len(p["up"]) for o, p in plans.items()
                    if o in pending)))
        replies = await batched_sub_reads(
            backend, read_list, "scrub", timeout)
        backend.perf.inc("scrub_chunks")
        for (osd, s, to_read, _attrs), reply in zip(read_list, replies):
            if reply is None:
                continue  # never answered: the shard reads as missing
            for oid in to_read:
                slot = state[oid].setdefault(
                    s, {"data": b"", "attrs": {}, "error": None})
                if oid in reply.errors:
                    slot["error"] = reply.errors[oid]
                    slot["data"] = None
                    continue
                attrs = reply.attrs_read.get(oid) or {}
                if attrs:
                    # re-read each round: a version that MOVES between
                    # chunks marks a mid-scrub write (deferral, not a
                    # false parity error)
                    slot.setdefault("versions", set())
                    slot["versions"].add(vt(attrs.get(VERSION_KEY)))
                    if first:
                        slot["attrs"] = attrs
                    total = plans[oid]["total"]
                    if attrs.get(SIZE_KEY) is not None and total is None:
                        plans[oid]["total"] = backend._shard_bytes_total(
                            attrs[SIZE_KEY])
                bufs = reply.buffers_read.get(oid)
                if bufs is not None and slot["data"] is not None:
                    slot["data"] += bufs[0][1]
                    slot["had_buf"] = True
        done = set()
        for oid in pending:
            plan = plans[oid]
            plan["off"] += chunk_max
            total = plan["total"]
            if total is None or plan["off"] >= total:
                done.add(oid)
        pending -= done
        first = False
        if pending and throttle is not None:
            await throttle.pace()  # chunk-cursor pacing between rounds
    return state
