"""Admin socket: per-daemon unix-socket command server.

Port of ``ceph_tpu/utils/admin_socket.py``; the protocol is the same, so
either package's client talks to either package's server.

Reference: src/common/admin_socket.cc -- every daemon listens on a unix
domain socket (``/var/run/ceph/<name>.asok``) and serves introspection
commands (``ceph daemon <sock> perf dump`` / ``ops`` / ``config show`` /
``help``).  Protocol here: one JSON request line ``{"prefix": ...}`` in,
one JSON document out (the reference reads a JSON command and writes a
length-prefixed JSON reply; newline-delimited keeps the same shape
without the 4-byte header).

Commands self-register like the reference's AdminSocketHook: the OSD
daemon registers ``perf dump`` (PerfCounters), ``ops`` /
``dump_historic_ops`` (OpTracker), ``config show`` / ``config set``
(md_config) and ``status``.
"""

from __future__ import annotations

import asyncio
import json
import os
from typing import Callable, Dict, Optional


class AdminSocket:
    def __init__(self, path: str):
        self.path = path
        self._hooks: Dict[str, Callable[[dict], object]] = {}
        self._server: Optional[asyncio.AbstractServer] = None
        self.register("help", lambda cmd: sorted(self._hooks))

    def register(self, prefix: str, hook: Callable[[dict], object]) -> None:
        """AdminSocket::register_command; hook(cmd_dict) -> JSON-able
        (or an awaitable of one -- async hooks are awaited in the serve
        loop, so introspection commands may take the daemon's locks
        through the normal async surface)."""
        self._hooks[prefix] = hook

    async def start(self) -> str:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        try:
            os.unlink(self.path)  # stale socket from a crashed daemon
        except FileNotFoundError:
            pass
        self._server = await asyncio.start_unix_server(
            self._serve, path=self.path
        )
        return self.path

    async def stop(self) -> None:
        # swap-then-await: claim the server synchronously so concurrent
        # stop() calls cannot both pass the None check and one of them
        # close a server the other is still awaiting on
        server, self._server = self._server, None
        if server is not None:
            server.close()
            await server.wait_closed()
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass

    async def _serve(self, reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> None:
        try:
            line = await reader.readline()
            try:
                cmd = json.loads(line.decode() or "{}")
            except json.JSONDecodeError:
                cmd = {"prefix": line.decode().strip()}
            prefix = cmd.get("prefix", "")
            hook = self._hooks.get(prefix)
            if hook is None:
                out = {"error": f"unknown command {prefix!r}",
                       "commands": sorted(self._hooks)}
            else:
                try:
                    out = hook(cmd)
                    if asyncio.iscoroutine(out) or \
                            isinstance(out, asyncio.Future):
                        out = await out
                except Exception as e:  # noqa: BLE001 -- a hook crash
                    out = {"error": f"{type(e).__name__}: {e}"}
            writer.write(json.dumps(out).encode() + b"\n")
            await writer.drain()
        finally:
            writer.close()


async def admin_command(path: str, prefix: str, **fields):
    """Client side (the ``ceph daemon <sock> <cmd>`` role).  The read
    limit is raised well past asyncio's 64 KiB default: one-line JSON
    replies grow with the daemon (the prometheus exposition and the
    profiler's speedscope dump both cross 64 KiB on a busy daemon)."""
    reader, writer = await asyncio.open_unix_connection(
        path, limit=64 << 20)
    writer.write(json.dumps(dict(fields, prefix=prefix)).encode() + b"\n")
    await writer.drain()
    line = await reader.readline()
    writer.close()
    return json.loads(line.decode())
