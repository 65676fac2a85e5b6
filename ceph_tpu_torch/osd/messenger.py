"""Async messenger-lite: typed message bus with fault injection.

Port of ``ceph_tpu/osd/messenger.py``.

Plays the role of the reference's Messenger/Connection/Dispatcher stack
(reference: src/msg/Messenger.h:40, AsyncMessenger event loops) for the
in-process mini-cluster: entities register a dispatcher, connections carry
ordered messages, and a config-driven fault injector can drop or delay
messages (the ms_inject_socket_failures / ms_inject_delay analogue,
reference: src/common/options.cc:735-756).

asyncio-based: each entity's dispatch loop is a task; send_message is
fire-and-forget like the reference's lossy client policy, with sequence
numbers preserved per connection (lossless-peer ordering).
"""

from __future__ import annotations

import asyncio
from typing import Awaitable, Callable, Dict, Iterable, Optional, Tuple

# FaultInjector moved to the transport layer in round 8 (the msg -> osd
# layering inversion fix); re-exported here for compatibility.
from ceph_tpu_torch.msg.fault import FaultInjector  # noqa: F401


class Messenger:
    """Process-wide bus; entities are addressed by name ("osd.3", "client")."""

    def __init__(self, fault: Optional[FaultInjector] = None):
        self._queues: Dict[str, asyncio.Queue] = {}
        self._dispatchers: Dict[str, Callable] = {}
        self._tasks: Dict[str, asyncio.Task] = {}
        self._down: set = set()
        self.fault = fault if fault is not None else \
            FaultInjector.from_config()
        self._seq = 0

    def register(self, name: str, dispatcher: Callable[[str, object], Awaitable[None]]):
        """dispatcher(from_name, message) coroutine; starts the entity's
        dispatch loop (the reference's ms_fast_dispatch role)."""
        self._queues[name] = asyncio.Queue()
        self._dispatchers[name] = dispatcher
        self._tasks[name] = asyncio.get_event_loop().create_task(
            self._dispatch_loop(name)
        )

    async def _dispatch_loop(self, name: str):
        queue = self._queues[name]
        while True:
            src, msg = await queue.get()
            if name in self._down:
                continue  # dropped on the floor like a dead OSD
            try:
                await self._dispatchers[name](src, msg)
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 -- a dispatcher crash
                import sys, traceback

                traceback.print_exc(file=sys.stderr)

    async def send_message(self, src: str, dst: str, msg: object) -> None:
        """Ordered, lossy-under-injection delivery."""
        if src in self._down:
            return  # a dead entity cannot send either
        if dst in self._down or dst not in self._queues:
            return  # lossy: messages to dead peers vanish
        if self.fault.maybe_drop():
            return
        await self.fault.maybe_delay()
        hold = self.fault.send_hold(src, msg)
        if hold:
            await asyncio.sleep(hold)
        self._seq += 1
        await self._queues[dst].put((src, msg))

    async def send_messages(
        self, src: str, pairs: Iterable[Tuple[str, object]]
    ) -> None:
        """Multi-destination submit: publish a whole fan-out (e.g. every
        EC sub-op of one client write) in one call.  On the in-process
        bus this is a plain loop; the TCP messenger uses the single
        submission to cork per-peer frame bursts (one writev + one drain
        per peer instead of one per message)."""
        for dst, msg in pairs:
            await self.send_message(src, dst, msg)

    def adopt_task(self, name: str, task: "asyncio.Task") -> None:
        """Track an auxiliary task (e.g. a daemon's tick loop) so shutdown
        cancels it with the dispatch loops.  Completed tasks prune
        themselves -- per-op tasks (client ops, notify acks) would
        otherwise accumulate without bound -- and log any unhandled
        exception on the way out: a silently-dead tick loop is the same
        outage as a wedged one, just later."""
        from ceph_tpu_torch.utils.aio import log_task_exception

        self._tasks[name] = task

        def _done(t, name=name):
            log_task_exception(t, name)
            if self._tasks.get(name) is t:
                self._tasks.pop(name, None)

        task.add_done_callback(_done)

    # -- failure control (thrasher hooks) ----------------------------------

    def mark_down(self, name: str) -> None:
        self._down.add(name)

    def mark_up(self, name: str) -> None:
        self._down.discard(name)

    def is_down(self, name: str) -> bool:
        return name in self._down

    async def shutdown(self) -> None:
        # Snapshot: the adopt_task done-callbacks prune self._tasks as each
        # cancelled task completes, so iterating the live dict here races
        # with its own mutation (dictionary-changed-size RuntimeError).
        #
        # Cancel in ROUNDS, not once: under py<3.11 asyncio.wait_for can
        # swallow a cancellation that races its future's completion
        # (bpo-42130).  A tick loop whose peering pass lost its one
        # cancel that way keeps running and then blocks forever on a
        # reply future no (cancelled) dispatch loop will ever resolve --
        # the whole-suite wedge the tier-1 run hit.  Re-cancelling lands
        # the next CancelledError at the task's next await point.
        tasks = [t for t in self._tasks.values() if not t.done()]
        for _ in range(50):
            if not tasks:
                return
            for task in tasks:
                task.cancel()
            done, pending = await asyncio.wait(tasks, timeout=0.5)
            tasks = list(pending)
        # a task still alive after 50 cancel rounds is looping over
        # CancelledError; abandon it rather than hang the caller
        import sys

        for task in tasks:
            print(f"messenger shutdown: abandoning {task}", file=sys.stderr)
