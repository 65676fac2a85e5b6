"""Lockdep: lock-order cycle detection for the asyncio data path.

Port of ``ceph_tpu/utils/lockdep.py``.

Reference: src/common/lockdep.h:20-25 -- the reference registers every
Mutex by name, records the acquisition-order graph, and aborts on a
cycle (a potential deadlock) the FIRST time the bad order happens, not
the unlucky time both tasks interleave.  The asyncio engine has the
same hazard class (await points interleave tasks holding asyncio.Locks:
object locks, extent pins, clone/head nesting), so the rail is the
same: ``TrackedLock`` wraps asyncio.Lock, tracks per-task held sets,
adds class-order edges on each acquisition, and raises ``LockdepError``
on a cycle.

Lock *classes* (the dedup key) are the names passed in; per-object
locks share a class with a hierarchy suffix ("object:head" vs
"object:clone") so the legitimate head->clone nesting is one edge while
the reverse order is flagged.  Enabled via the ``lockdep`` config
option (like the reference's lockdep=true); zero overhead when off.
"""

from __future__ import annotations

import asyncio
from typing import Dict, List, Set


class LockdepError(RuntimeError):
    """A lock-order cycle (potential deadlock) was detected."""


#: acquisition-order edges: held-class -> {acquired-classes}
_order: Dict[str, Set[str]] = {}
#: per-task held lock classes (keyed by id(task))
_held: Dict[int, List[str]] = {}


def _reaches(src: str, dst: str, seen=None) -> bool:
    if src == dst:
        return True
    seen = seen or set()
    for nxt in _order.get(src, ()):
        if nxt not in seen:
            seen.add(nxt)
            if _reaches(nxt, dst, seen):
                return True
    return False


def clear() -> None:
    """Reset the global order graph (tests)."""
    _order.clear()
    _held.clear()


def enabled() -> bool:
    try:
        from ceph_tpu_torch.utils.config import get_config

        return bool(get_config().get_val("lockdep"))
    except KeyError:
        return False


class TrackedLock:
    """asyncio.Lock with lockdep order tracking (common/Mutex + lockdep
    registration role)."""

    def __init__(self, name: str):
        self.name = name
        self._lock = asyncio.Lock()

    def _task_key(self) -> int:
        t = asyncio.current_task()
        return id(t) if t is not None else 0

    async def __aenter__(self):
        key = self._task_key()
        held = _held.setdefault(key, [])
        for h in held:
            if h == self.name:
                raise LockdepError(
                    f"recursive acquisition of lock class {self.name!r}"
                )
            # adding edge h -> self; a path self -> h means some task
            # acquires them in the opposite order: cycle
            if _reaches(self.name, h):
                raise LockdepError(
                    f"lock order cycle: acquiring {self.name!r} while "
                    f"holding {h!r}, but {self.name!r} -> {h!r} order "
                    "was already recorded"
                )
            _order.setdefault(h, set()).add(self.name)
        await self._lock.acquire()
        held.append(self.name)
        return self

    async def __aexit__(self, *exc):
        key = self._task_key()
        held = _held.get(key, [])
        if self.name in held:
            held.remove(self.name)
        if not held:
            _held.pop(key, None)
        self._lock.release()
        return False

    def locked(self) -> bool:
        return self._lock.locked()
