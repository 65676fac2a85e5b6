"""rbd-replay: capture and replay RBD I/O workloads.

Port of ``ceph_tpu/rbd/replay.py``.

Reference: src/rbd_replay (~2.7k LoC) -- ``rbd-replay-prep`` turns an
LTTng trace of librbd calls into an action file; ``rbd-replay``
re-issues those actions against an image, preserving think time and
dependencies.  Here the capture side is a recording proxy around
``Image`` (the framework's librbd surface is async Python, so proxying
beats out-of-band tracing), producing a JSONL action file the replayer
re-issues with optional speed scaling.

Actions: {"ts": seconds-from-start, "op": ..., ...op fields...}.
"""

from __future__ import annotations

import asyncio
import base64
import json
import time
from typing import List, Optional

from ceph_tpu_torch.rbd.image import Image


class RecordingImage:
    """Proxy that forwards to a real Image and appends each mutating or
    reading op to an in-memory trace (rbd-replay-prep's action list)."""

    def __init__(self, image: Image):
        self._img = image
        self.actions: List[dict] = []
        self._t0 = time.perf_counter()

    def _log(self, op: str, **fields) -> None:
        self.actions.append(
            dict({"ts": round(time.perf_counter() - self._t0, 6),
                  "op": op}, **fields))

    async def write(self, offset: int, data: bytes) -> None:
        self._log("write", off=offset,
                  data=base64.b64encode(bytes(data)).decode())
        await self._img.write(offset, data)

    async def read(self, offset: int, length: int) -> bytes:
        self._log("read", off=offset, len=length)
        return await self._img.read(offset, length)

    async def discard(self, offset: int, length: int) -> None:
        self._log("discard", off=offset, len=length)
        await self._img.discard(offset, length)

    async def resize(self, size: int) -> None:
        self._log("resize", size=size)
        await self._img.resize(size)

    async def snap_create(self, snap: str) -> int:
        self._log("snap_create", name=snap)
        return await self._img.snap_create(snap)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            for a in self.actions:
                f.write(json.dumps(a) + "\n")


def load_trace(path: str) -> List[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


async def replay(image: Image, actions: List[dict],
                 speed: float = 0.0) -> dict:
    """Re-issue a trace against ``image``.  ``speed`` > 0 preserves
    inter-op think time scaled by 1/speed (rbd-replay --pacing role);
    0 replays as fast as possible.  Returns op counts + elapsed."""
    counts: dict = {}
    t0 = time.perf_counter()
    prev_ts: Optional[float] = None
    for a in actions:
        if speed > 0 and prev_ts is not None:
            gap = (a["ts"] - prev_ts) / speed
            if gap > 0:
                await asyncio.sleep(gap)
        prev_ts = a["ts"]
        op = a["op"]
        counts[op] = counts.get(op, 0) + 1
        if op == "write":
            await image.write(a["off"], base64.b64decode(a["data"]))
        elif op == "read":
            await image.read(a["off"], a["len"])
        elif op == "discard":
            await image.discard(a["off"], a["len"])
        elif op == "resize":
            await image.resize(a["size"])
        elif op == "snap_create":
            try:
                await image.snap_create(a["name"])
            except IOError as e:
                # tolerate ONLY already-exists (-17): swallowing a real
                # failure would skip the COW point and diverge silently
                if "rc=-17" not in str(e):
                    raise
        else:
            raise ValueError(f"unknown trace op {op!r}")
    return {"ops": counts, "elapsed": time.perf_counter() - t0}
