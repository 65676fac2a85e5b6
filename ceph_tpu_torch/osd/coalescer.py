"""Per-PG codec batching for the OSD EC data path (the encode coalescer).

Port of ``ceph_tpu/osd/coalescer.py``.  The stripe-batching pipeline
(``ceph_tpu_torch/ops/pipeline.py``) fuses many stripes into one device
dispatch, but a client op that makes its own synchronous codec call
gains nothing from it: once the codec is fast, per-op datapath overheads
dominate -- the pattern "Understanding System Characteristics of Online
Erasure Coding" documents.

This module is the seam that closes the gap: concurrent in-flight client
ops on one PG gather their codec work into batched dispatches.  (In the
JAX package it is also the mesh data plane's dispatch seam; the port has
no mesh plane yet.)

Flush policy (documented in docs/ec-storage-path.md):

* **queue-drain**: the first submission of a batch schedules a flush via
  ``loop.call_soon``, i.e. the batch dispatches at the end of the current
  event-loop tick, after every already-runnable task has had its chance
  to add its stripe.  Latency cost is bounded by one loop tick; a lone
  write is dispatched immediately on the next callback slot.
* **size threshold**: a batch that reaches ``max_batch`` items or
  ``max_bytes`` payload bytes dispatches immediately (bounded memory).
* **bounded depth**: at most ``depth`` batched dispatches run
  concurrently; excess batches queue behind a semaphore.

Deadlock-freedom argument (mirrors the round-4 dispatch throttle's
scoping): only CLIENT ops route through the coalescer -- recovery,
scrub and peering reconstruction keep their direct codec calls -- and a
flush depends on nothing but the event loop running (``call_soon`` always
fires; it never waits on another op's completion, an ack, or a quota
held by a queued op).  Submitters await only their own future, and the
dispatch function never re-enters the coalescer, so no cycle of waits
can form.
"""

from __future__ import annotations

import asyncio
from typing import Awaitable, Callable, List, Optional, Sequence

from ceph_tpu_torch.profiling import ledger as _profiler
from ceph_tpu_torch.utils import trace
from ceph_tpu_torch.utils.perf import PerfCounters

#: wire-tax cost centers on the submit path (ceph_tpu_torch/profiling/):
#: the sync gather bookkeeping and the fused dispatch call.  The
#: dispatch marker uses the paired stage_enter/stage_exit form because
#: dispatch_many may return a coroutine that must be awaited OUTSIDE
#: the stage (a stage spanning an await would bill other tasks' work
#: to itself) -- the cephlint rule `profile-stage-unpaired` checks
#: every enter reaches an exit on all CFG paths.
_PS_SUBMIT = _profiler.stage("coalescer.submit")
_PS_DISPATCH = _profiler.stage("coalescer.dispatch")

#: default flush thresholds: a batch larger than this dispatches without
#: waiting for the tick to end
DEFAULT_MAX_BATCH = 64
DEFAULT_MAX_BYTES = 64 << 20
#: bounded in-flight batched dispatches (the pipeline overlaps granules
#: internally; this bounds whole-batch concurrency)
DEFAULT_DEPTH = 2


class BatchCoalescer:
    """Gathers same-kind work items submitted in one event-loop tick into
    one batched dispatch.

    ``dispatch_many(items) -> results`` is called with every item of a
    batch (in submission order) and must return one result per item; it
    may be sync or async.  ``submit(item, nbytes)`` awaits that item's
    result.  Per-instance, single-event-loop; not thread-safe (the OSD
    data path is asyncio-single-threaded by construction).
    """

    def __init__(
        self,
        dispatch_many: Callable[[List], "Sequence | Awaitable[Sequence]"],
        *,
        max_batch: int = DEFAULT_MAX_BATCH,
        max_bytes: int = DEFAULT_MAX_BYTES,
        depth: int = DEFAULT_DEPTH,
        perf: Optional[PerfCounters] = None,
        counter: str = "coalesce",
    ):
        self._dispatch_many = dispatch_many
        self.max_batch = max_batch
        self.max_bytes = max_bytes
        self._sem = asyncio.Semaphore(max(1, depth))
        #: unified QoS admission (osd/qos.py, set by the hosting
        #: OSDShard): when present, a gathered batch claims one
        #: admission slot under ``qos_class`` with cost = its stripe
        #: bytes BEFORE dispatching -- the dequeue that frees the slot
        #: to this batch IS the dmClock decision, so batching and QoS
        #: are one layer.  None (client-side engines, unified QoS off)
        #: dispatches on the depth semaphore alone.
        self.admission = None
        self.qos_class = "client"
        self._pending: List[tuple] = []  # (item, future, nbytes, span)
        self._pending_bytes = 0
        self._flush_scheduled = False
        self.perf = perf
        self._counter = counter
        #: trace stage name ("encode"/"decode"/...): op spans record
        #: <stage>_submit/<stage>_done and the shared dispatch becomes
        #: one batch_<stage> fan-in span (docs/observability.md)
        self._stage = "encode" if "encode" in counter else (
            "decode" if "decode" in counter else counter)
        # precomputed event/span names: the unsampled fast path must
        # not pay a per-submit f-string
        self._ev_submit = f"{self._stage}_submit"
        self._ev_done = f"{self._stage}_done"
        self._span_name = f"batch_{self._stage}"

    # -- submission ---------------------------------------------------------

    async def submit(self, item, nbytes: int = 0):
        """Queue one work item; resolves with its dispatch result."""
        with _PS_SUBMIT:
            loop = asyncio.get_event_loop()
            fut = loop.create_future()
            # batch fan-in tracing: remember the submitting op's span so
            # the shared dispatch becomes ONE span child of every rider
            # (cheap: a contextvar read; NULL_SPAN rides as False)
            span = trace.current()
            span.event(self._ev_submit)
            self._pending.append((item, fut, nbytes, span))
            self._pending_bytes += nbytes
            if (
                len(self._pending) >= self.max_batch
                or self._pending_bytes >= self.max_bytes
            ):
                self._spawn_flush(loop)
            elif not self._flush_scheduled:
                # queue-drain flush: end of the current tick, so every
                # task runnable RIGHT NOW can still join this batch
                self._flush_scheduled = True
                loop.call_soon(self._on_tick_end, loop)
        return await fut

    def _on_tick_end(self, loop) -> None:
        self._flush_scheduled = False
        if self._pending:
            self._spawn_flush(loop)

    def _spawn_flush(self, loop) -> None:
        # the swap and the byte-counter reset are one indivisible step:
        # a task switch between them would let a submit() land in the
        # NEW pending list while its bytes are zeroed away with the old
        # one (declared so the rule fires if this ever grows an await)
        # cephlint: atomic-section coalescer-pending-swap
        batch, self._pending = self._pending, []
        self._pending_bytes = 0
        # cephlint: end-atomic-section
        task = loop.create_task(self._run_batch(batch))
        # keep a strong reference until the batch lands (asyncio tasks
        # are otherwise collectable mid-flight)
        refs = getattr(self, "_tasks", None)
        if refs is None:
            refs = self._tasks = set()
        refs.add(task)
        task.add_done_callback(refs.discard)

    def _dispatch_staged(self, items: List):
        """The staged dispatch call, paired-marker form: the
        synchronous ``dispatch_many`` invocation is a cost center; a
        coroutine result is awaited by the CALLER, outside the stage
        (stages never span a yield -- a suspended stage would bill
        other tasks' work to itself).  profile-stage-unpaired checks
        the enter reaches the exit on every CFG path."""
        _profiler.stage_enter(_PS_DISPATCH)
        try:
            results = self._dispatch_many(items)
        finally:
            _profiler.stage_exit(_PS_DISPATCH)
        return results

    async def _run_batch(self, batch: List[tuple]) -> None:
        admission = self.admission
        if admission is not None:
            # the QoS admission stage: one slot per batched dispatch,
            # cost = the batch's payload bytes.  Waits only on slot
            # releases and the clock (never on another op's completion),
            # so the coalescer's deadlock-freedom argument holds intact.
            async with admission.slot(
                self.qos_class,
                sum(nb for _i, _f, nb, _sp in batch),
            ):
                await self._run_batch_admitted(batch)
        else:
            await self._run_batch_admitted(batch)

    async def _run_batch_admitted(self, batch: List[tuple]) -> None:
        async with self._sem:
            items = [item for item, _fut, _nb, _sp in batch]
            # the shared stage is ONE fan-in span, child of every
            # sampled rider (amortized_over = batch size); it is also
            # the task-current span while dispatching, so the dispatch
            # lane (mesh plane, pipeline) can annotate it
            fanin = trace.batch_span(
                self._span_name, [sp for _i, _f, _nb, sp in batch])
            try:
                with trace.use_span(fanin):
                    results = self._dispatch_staged(items)
                    if asyncio.iscoroutine(results):
                        results = await results
            except asyncio.CancelledError:
                fanin.finish()
                raise
            except Exception as e:  # noqa: BLE001 -- each waiter gets the
                # failure; the coalescer itself stays serviceable
                fanin.tag_set("error", type(e).__name__)
                fanin.finish()
                for _item, fut, _nb, sp in batch:
                    sp.event(self._ev_done)
                    if not fut.done():
                        fut.set_exception(
                            type(e)(*e.args) if e.args else IOError(str(e))
                        )
                return
            fanin.tag_set("items", len(batch))
            fanin.finish()
            if self.perf is not None:
                self.perf.inc(self._counter)
                self.perf.inc(f"{self._counter}_items", len(batch))
                self.perf.inc(f"{self._counter}_bytes",
                              sum(nb for _i, _f, nb, _sp in batch))
                if len(batch) > 1:
                    self.perf.inc(f"{self._counter}_batched",
                                  len(batch))
                # largest fused batch this coalescer ever dispatched:
                # the mesh data plane slices a batch over the pg axis,
                # so this is the "how much parallelism did one tick
                # actually gather" number the mesh bench reads
                self.perf.hwm(f"{self._counter}_batch_hwm", len(batch))
            for (_item, fut, _nb, sp), res in zip(batch, results):
                sp.event(self._ev_done)
                if not fut.done():
                    fut.set_result(res)
