"""Leveled per-subsystem logging with an in-memory ring (dout / log::Log
equivalents).

Port of ``ceph_tpu/utils/log.py``, over the port's ``utils/config.py``.

Reference: src/common/dout.h gated `dout(n)` macros per subsystem
(src/log/SubsystemMap.h), async writer with a recent-entries ring kept for
crash dumps (src/log/Log.cc).  Here: ``dout(subsys, level)`` checks the
config's debug_<subsys> gather level; entries go to a bounded ring and,
above the stderr threshold, to stderr.
"""

from __future__ import annotations

import collections
import sys
import threading
import time
from typing import Deque, Tuple

from ceph_tpu_torch.utils.config import get_config

_RING_SIZE = 10000
_ring: Deque[Tuple[float, str, int, str]] = collections.deque(maxlen=_RING_SIZE)
_lock = threading.Lock()
_stderr_level = 0  # entries at level <= this also print


def set_stderr_level(level: int) -> None:
    global _stderr_level
    _stderr_level = level


def should_gather(subsys: str, level: int) -> bool:
    try:
        return level <= get_config().get_val(f"debug_{subsys}")
    except KeyError:
        return False


def dout(subsys: str, level: int, message: str) -> None:
    if not should_gather(subsys, level):
        return
    entry = (time.time(), subsys, level, message)
    with _lock:
        _ring.append(entry)
    if level <= _stderr_level:
        print(f"[{subsys}:{level}] {message}", file=sys.stderr)


def derr(subsys: str, message: str) -> None:
    entry = (time.time(), subsys, -1, message)
    with _lock:
        _ring.append(entry)
    print(f"[{subsys}:ERR] {message}", file=sys.stderr)


def recent_entries(count: int = 100):
    """Crash-dump view of the in-memory ring (log::Log::dump_recent role)."""
    with _lock:
        return list(_ring)[-count:]
