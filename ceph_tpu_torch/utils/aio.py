"""Small asyncio utilities: executor-backed file I/O and task hygiene.

Port of ``ceph_tpu/utils/aio.py``.

The daemons and CLI tools are fully async; builtin ``open`` in a
coroutine stalls every dispatch loop sharing the event loop (the
cephlint ``async-blocking-call`` rule).  These helpers route the few
file touches the async paths need (address maps, keyrings, CLI
payloads) through the default executor.

``log_task_exception`` is the done-callback half of the
``async-orphan-task`` discipline: a retained task whose exception is
never read still fails silently (asyncio only warns at GC time, if
ever); attaching this callback makes the failure visible the moment
the task dies.
"""

from __future__ import annotations

import asyncio
import json
import sys
from typing import Any, Optional


async def read_text(path: str) -> str:
    loop = asyncio.get_event_loop()

    def _read() -> str:
        with open(path) as f:
            return f.read()

    return await loop.run_in_executor(None, _read)


async def read_bytes(path: str) -> bytes:
    loop = asyncio.get_event_loop()

    def _read() -> bytes:
        with open(path, "rb") as f:
            return f.read()

    return await loop.run_in_executor(None, _read)


async def read_json(path: str) -> Any:
    return json.loads(await read_text(path))


async def write_text(path: str, data: str) -> None:
    loop = asyncio.get_event_loop()

    def _write() -> None:
        with open(path, "w") as f:
            f.write(data)

    await loop.run_in_executor(None, _write)


async def write_bytes(path: str, data: bytes) -> None:
    loop = asyncio.get_event_loop()

    def _write() -> None:
        with open(path, "wb") as f:
            f.write(data)

    await loop.run_in_executor(None, _write)


def log_task_exception(task: "asyncio.Task",
                       context: Optional[str] = None) -> None:
    """Done-callback: surface a task's unhandled exception on stderr
    (CancelledError is the normal shutdown path and stays silent)."""
    if task.cancelled():
        return
    exc = task.exception()
    if exc is None:
        return
    name = context or getattr(task, "get_name", lambda: repr(task))()
    print(f"task {name!r} died: {exc!r}", file=sys.stderr)
    import traceback

    traceback.print_exception(type(exc), exc, exc.__traceback__,
                              file=sys.stderr)
