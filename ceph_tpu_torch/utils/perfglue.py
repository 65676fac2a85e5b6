"""perfglue: CPU profiler glue, admin-socket triggered.

Port of ``ceph_tpu/utils/perfglue.py``.

Reference: src/perfglue/cpu_profiler.cc -- the reference links
gperftools and exposes ``cpu_profiler start/stop/dump`` over the admin
socket.  The Python runtime's equivalent is cProfile: start/stop a
profiler around live daemon execution and dump the hottest functions,
all through the same admin-socket command the reference uses.
"""

from __future__ import annotations

import cProfile
import io
import pstats
from typing import Optional


class CpuProfiler:
    """One per daemon (the cpu_profiler command handler)."""

    def __init__(self):
        self._prof: Optional[cProfile.Profile] = None

    def handle_command(self, cmd: dict):
        action = cmd.get("action", "status")
        if action == "start":
            if self._prof is not None:
                return {"error": "profiler already running"}
            self._prof = cProfile.Profile()
            self._prof.enable()
            return {"status": "started"}
        if action == "stop":
            if self._prof is None:
                return {"error": "profiler not running"}
            self._prof.disable()
            buf = io.StringIO()
            stats = pstats.Stats(self._prof, stream=buf)
            stats.sort_stats("cumulative").print_stats(
                int(cmd.get("top", 20))
            )
            self._prof = None
            return {"status": "stopped", "report": buf.getvalue()}
        if action == "status":
            return {"running": self._prof is not None}
        return {"error": f"unknown action {action!r}"}


def register(asok, name: str = "cpu_profiler") -> CpuProfiler:
    """Attach a profiler to a daemon's admin socket
    (AdminSocket::register_command in global init, perfglue role)."""
    prof = CpuProfiler()
    asok.register(name, prof.handle_command)
    return prof
