"""Thread stack sampler: stage-attributed flamegraph evidence.

Port of ``ceph_tpu/profiling/sampler.py``; it reads the port's ledger
(``ledger.current_stage_name``: the C markers' chain or the Python one).

The ledger says WHAT each declared stage costs; the sampler says WHERE
inside a stage the time goes, without instrumenting anything -- a
background thread snapshots the event-loop thread's stack at
``profile_sample_hz`` via ``sys._current_frames()`` and attributes each
sample to the ledger's innermost active stage (``unattributed`` between
stages).  This is the signal/thread-sampler arm of the wire-tax
profiler: safe under asyncio (no signal delivery into the loop thread),
portable, and bounded (distinct stacks cap at ``_STACK_CAP``; overflow
is counted, never silently dropped).

Exports:

* :meth:`StackSampler.speedscope` -- a speedscope.app ``sampled``
  profile (shared frame table + per-sample frame-index stacks +
  weights), one profile per attributed stage so the viewer's profile
  picker IS the cost-center picker.
* :meth:`StackSampler.collapsed` -- Brendan-Gregg collapsed/folded
  lines (``stage;outer;...;leaf count``) for flamegraph.pl-style
  tooling and cheap diffing in tests.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

#: bound on distinct (stage, stack) keys retained
_STACK_CAP = 8192
#: frames deeper than this are truncated from the root side (the leaf
#: frames carry the attribution signal)
_MAX_DEPTH = 48


class StackSampler:
    """Samples ``target_thread`` (default: the thread that constructs
    the sampler) from a daemon thread until :meth:`stop`."""

    def __init__(self, hz: float = 87.0,
                 target_thread_id: Optional[int] = None):
        self.interval = 1.0 / max(1.0, float(hz))
        self.target_thread_id = (
            target_thread_id if target_thread_id is not None
            else threading.get_ident())
        #: (stage, (frame, frame, ...)) -> sample count; frames are
        #: "qualname (file:line)" strings leaf-last
        self.stacks: Dict[Tuple[str, Tuple[str, ...]], int] = {}
        self.samples = 0
        self.dropped = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- sampling -----------------------------------------------------------

    def _snap_once(self) -> None:
        from ceph_tpu_torch.profiling import ledger

        frame = sys._current_frames().get(self.target_thread_id)
        if frame is None:
            return
        stack: List[str] = []
        depth = 0
        while frame is not None and depth < _MAX_DEPTH:
            code = frame.f_code
            stack.append(
                f"{code.co_qualname if hasattr(code, 'co_qualname') else code.co_name}"  # noqa: E501
                f" ({code.co_filename.rsplit('/', 1)[-1]}:"
                f"{frame.f_lineno})")
            frame = frame.f_back
            depth += 1
        stack.reverse()  # root first
        stage = ledger.current_stage_name() or "unattributed"
        key = (stage, tuple(stack))
        if key not in self.stacks and len(self.stacks) >= _STACK_CAP:
            self.dropped += 1
            return
        self.stacks[key] = self.stacks.get(key, 0) + 1
        self.samples += 1

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self._snap_once()
            except Exception:  # noqa: BLE001 -- a torn frame walk (the
                # target mutated under us) just loses one sample
                pass

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="ceph-tpu-torch-profiler", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=2.0)

    # -- attribution views --------------------------------------------------

    def stage_shares(self) -> Dict[str, float]:
        """Fraction of samples per attributed stage."""
        totals: Dict[str, int] = {}
        for (stage, _stack), n in self.stacks.items():
            totals[stage] = totals.get(stage, 0) + n
        total = sum(totals.values())
        if not total:
            return {}
        return {stage: round(n / total, 4)
                for stage, n in sorted(totals.items())}

    # -- exports ------------------------------------------------------------

    def collapsed(self) -> str:
        """Folded-stack lines ``stage;root;...;leaf count``."""
        lines = []
        for (stage, stack), n in sorted(self.stacks.items()):
            lines.append(";".join((stage,) + stack) + f" {n}")
        return "\n".join(lines)

    def speedscope(self, name: str = "ceph_tpu_torch wire-tax") -> dict:
        """A speedscope file (schema
        https://www.speedscope.app/file-format-schema.json): one
        ``sampled`` profile per attributed stage, shared frame table.
        Sample weights are the sampler interval (seconds)."""
        frame_index: Dict[str, int] = {}
        frames: List[dict] = []

        def fidx(f: str) -> int:
            i = frame_index.get(f)
            if i is None:
                i = frame_index[f] = len(frames)
                frames.append({"name": f})
            return i

        by_stage: Dict[str, List[tuple]] = {}
        for (stage, stack), n in sorted(self.stacks.items()):
            by_stage.setdefault(stage, []).append((stack, n))
        profiles = []
        for stage, rows in sorted(by_stage.items()):
            samples: List[List[int]] = []
            weights: List[float] = []
            for stack, n in rows:
                idx = [fidx(f) for f in stack]
                for _ in range(n):
                    samples.append(idx)
                    weights.append(self.interval)
            profiles.append({
                "type": "sampled",
                "name": stage,
                "unit": "seconds",
                "startValue": 0,
                "endValue": round(sum(weights), 6),
                "samples": samples,
                "weights": weights,
            })
        return {
            "$schema": "https://www.speedscope.app/file-format-schema.json",
            "name": name,
            "exporter": "ceph_tpu_torch.profiling",
            "activeProfileIndex": 0,
            "shared": {"frames": frames},
            "profiles": profiles,
            "exported_at": time.time(),
        }
