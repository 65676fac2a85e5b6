"""Sampled, bounded distributed-trace spans (ZTracer/blkin analogue).

Port of ``ceph_tpu/utils/trace.py``; the port keeps its own copy (its own
globals), so a process that imports both packages does not cross-feed
them.

Reference: src/common/zipkin_trace.h:40 ZTracer::Trace -- the EC write
path carries child spans across daemons (ECBackend.cc:2003-2008
trace.init("ec sub write"), :931 trace.event("handle_sub_write")).

Round 16 rewrote the seed stub into the observability substrate the
batched data plane needs (docs/observability.md):

* **Sampling**: ``trace_mode`` off | sampled | full.  In sampled mode
  one in ``trace_sample_every`` root traces is real; the rest get the
  shared :data:`NULL_SPAN` whose every method is a no-op, so the
  unsampled fast path costs one counter increment and a modulo.  The
  decision travels WITH the trace: a daemon that receives a wire
  context creates real spans, one that receives none creates nothing
  -- no per-hop re-rolling, no half-sampled traces.
* **Batch fan-in spans**: when N ops ride one shared stage (a
  coalescer batch, a corked burst, a fused encode dispatch, a mesh
  SPMD dispatch, a recovery multi-read), the stage is ONE span linked
  as a child of all N op spans (``parent_ids``) with
  ``amortized_over=N``.  Each op's timeline decomposes the shared
  interval into its amortized compute share plus batch wait -- no
  per-op double-timing (see :func:`op_timeline`).
* **Wire context**: ``span.to_wire()`` is a tiny ``[trace_id,
  span_id]`` pair carried as a TRAILING optional field on message
  bodies (reqid-style, ``# cephlint: wire-optional`` in msg/wire.py),
  so spans stitch client -> primary -> sub-write/sub-read across
  daemons and pre-trace peers interop unchanged.
* **Bounded collection**: finished spans land in a ring of
  ``trace_keep`` plus a slowest-roots retention ring of
  ``trace_keep_slow`` (the optracker historic-ring discipline); the
  seed's grow-forever ``_finished`` list is gone.  Drops are counted.

Span ids are salted with the pid so traces stitched across real
daemon processes cannot collide; the in-process mini-cluster shares
this module and stitches for free.
"""

from __future__ import annotations

import contextvars
import itertools
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

_MODES = ("off", "sampled", "full")

#: process-unique span id space: traces from different daemon
#: processes merge into one timeline without id collisions
_ID_BASE = (os.getpid() & 0x7FFF) << 44
_ids = itertools.count(_ID_BASE + 1)

_collector_lock = threading.Lock()
#: finished-span ring (bounded; trace_keep)
_finished: deque = deque(maxlen=256)
#: slowest finished ROOT spans, kept sorted by duration (trace_keep_slow)
_slow_roots: List["Span"] = []
#: started-but-unfinished real spans: id -> name (the ci smoke and the
#: trace-span-unfinished lint rule's runtime counterpart)
_live: Dict[int, str] = {}
_counters = {"finished": 0, "dropped": 0, "sampled_roots": 0,
             "unsampled_roots": 0, "live_overflow": 0}
#: hard cap on the live map so leaked spans cannot grow state forever
_LIVE_CAP = 4096

#: lazy-cached knobs (a per-op config lock acquisition would be real
#: overhead on the unsampled path; refresh via configure())
_mode: Optional[str] = None
_sample_every = 64
_keep_slow = 64
_sample_tick = 0

#: legacy surface (pre-round-16 callers used trace.enable/enabled)
enabled = False

#: the active span of THIS task (client ops run as their own tasks, so
#: contextvars keep concurrent ops' spans apart without threading a
#: parameter through every strategy signature -- the _OP_REQID pattern)
_CURRENT: "contextvars.ContextVar[Optional[Span]]" = \
    contextvars.ContextVar("ceph_tpu_trace_span", default=None)


def _load_config() -> None:
    global _mode, _sample_every, _keep_slow
    from ceph_tpu_torch.utils.config import get_config

    cfg = get_config()
    _mode = str(cfg.get_val("trace_mode"))
    if _mode not in _MODES:
        _mode = "off"
    _sample_every = max(1, int(cfg.get_val("trace_sample_every")))
    _keep_slow = max(1, int(cfg.get_val("trace_keep_slow")))
    keep = max(1, int(cfg.get_val("trace_keep")))
    with _collector_lock:
        if _finished.maxlen != keep:
            _resize_ring(keep)


def _resize_ring(keep: int) -> None:
    global _finished
    old = list(_finished)
    _finished = deque(old[-keep:], maxlen=keep)


def mode() -> str:
    if _mode is None:
        _load_config()
    return _mode  # type: ignore[return-value]


def configure(mode: Optional[str] = None,
              sample_every: Optional[int] = None,
              keep: Optional[int] = None,
              keep_slow: Optional[int] = None) -> None:
    """Set tracing knobs at runtime (and push them into the config so
    ``config show`` agrees); None leaves a knob alone."""
    from ceph_tpu_torch.utils.config import get_config

    cfg = get_config()
    if mode is not None:
        if mode not in _MODES:
            raise ValueError(f"bad trace mode {mode!r}")
        cfg.set_val("trace_mode", mode)
    if sample_every is not None:
        cfg.set_val("trace_sample_every", int(sample_every))
    if keep is not None:
        cfg.set_val("trace_keep", int(keep))
    if keep_slow is not None:
        cfg.set_val("trace_keep_slow", int(keep_slow))
    _load_config()
    global enabled
    enabled = _mode != "off"


def enable(on: bool = True) -> None:
    """Legacy toggle: ``True`` = full tracing, ``False`` = off (and the
    collector clears, as the seed behavior promised)."""
    configure(mode="full" if on else "off")
    if not on:
        clear()


def clear() -> None:
    with _collector_lock:
        _finished.clear()
        _slow_roots.clear()
        _live.clear()
        for key in _counters:
            _counters[key] = 0


def status() -> dict:
    m = mode()  # may lazily load config (takes the collector lock)
    with _collector_lock:
        return {
            "mode": m,
            "sample_every": _sample_every,
            "keep": _finished.maxlen,
            "keep_slow": _keep_slow,
            "finished": _counters["finished"],
            "dropped": _counters["dropped"],
            "sampled_roots": _counters["sampled_roots"],
            "unsampled_roots": _counters["unsampled_roots"],
            "unfinished": len(_live),
        }


def unfinished_count() -> int:
    """Started-but-unfinished real spans right now (0 after a quiesced
    workload -- the ci_lint traced-op smoke gates on this)."""
    with _collector_lock:
        return len(_live)


def unfinished_names() -> List[str]:
    with _collector_lock:
        return sorted(set(_live.values()))


class _NullSpan:
    """The unsampled span: every operation a no-op, one shared
    instance.  Truth-testing is False so ``if span:`` gates work."""

    __slots__ = ()
    sampled = False
    span_id = 0
    trace_id = 0
    parent_ids: Tuple[int, ...] = ()
    amortized_over = 1
    events: List[tuple] = []
    tags: Dict[str, object] = {}

    def event(self, name: str, t: Optional[float] = None) -> None:
        pass

    def tag_set(self, key: str, value) -> None:
        pass

    def link(self, parent: "Span") -> None:
        pass

    def child(self, name: str) -> "_NullSpan":
        return self

    def finish(self) -> None:
        pass

    def to_wire(self) -> None:
        return None

    @property
    def duration(self) -> float:
        return 0.0

    def __bool__(self) -> bool:
        return False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class Span:
    """One timed span.  ``parent_ids`` is a TUPLE: a batch fan-in span
    is the child of every op span whose work rode the shared stage."""

    __slots__ = (
        "name", "span_id", "trace_id", "parent_ids", "start", "wall",
        "end", "events", "tags", "amortized_over",
    )
    sampled = True

    def __init__(self, name: str, parent: Optional["Span"] = None,
                 trace_id: Optional[int] = None,
                 parent_ids: Sequence[int] = (),
                 t0: Optional[float] = None):
        self.name = name
        self.span_id = next(_ids)
        if parent is not None and parent.sampled:
            self.parent_ids: Tuple[int, ...] = (parent.span_id,)
            self.trace_id = parent.trace_id
        else:
            self.parent_ids = tuple(parent_ids)
            self.trace_id = trace_id if trace_id is not None \
                else self.span_id
        # t0 backdates the span start (a monotonic stamp taken before
        # the span object existed, e.g. queue entry) so queue wait is
        # attributed without allocating a span per queued op
        self.start = t0 if t0 is not None else time.monotonic()
        self.wall = time.time()
        self.end = 0.0
        self.events: List[tuple] = []
        self.tags: Dict[str, object] = {}
        self.amortized_over = 1
        with _collector_lock:
            if len(_live) >= _LIVE_CAP:
                _live.pop(next(iter(_live)), None)
                _counters["live_overflow"] += 1
            _live[self.span_id] = name

    # -- recording ---------------------------------------------------------

    def event(self, name: str, t: Optional[float] = None) -> None:
        """Timestamped event; ``t`` backdates it (a monotonic stamp
        taken before the span existed, e.g. enqueue time)."""
        self.events.append(
            ((t if t is not None else time.monotonic()) - self.start, name)
        )

    def tag_set(self, key: str, value) -> None:
        self.tags[key] = value

    def link(self, parent: "Span") -> None:
        """Fan-in: make this span a child of one more op span."""
        if parent.sampled and parent.span_id not in self.parent_ids:
            self.parent_ids = self.parent_ids + (parent.span_id,)
            if self.trace_id == self.span_id:
                self.trace_id = parent.trace_id

    def child(self, name: str) -> "Span":
        return Span(name, parent=self)

    def finish(self) -> None:
        if self.end:
            return  # idempotent: double-finish must not double-collect
        self.end = time.monotonic()
        with _collector_lock:
            _live.pop(self.span_id, None)
            if len(_finished) == _finished.maxlen:
                _counters["dropped"] += 1
            _finished.append(self)
            _counters["finished"] += 1
            if not self.parent_ids:
                # slowest-roots retention: the worst traces survive the
                # ring even under churn (optracker discipline)
                _slow_roots.append(self)
                _slow_roots.sort(key=lambda s: -s.duration)
                del _slow_roots[_keep_slow:]

    @property
    def duration(self) -> float:
        return (self.end or time.monotonic()) - self.start

    def to_wire(self) -> List[int]:
        """The on-the-wire context: tiny, trailing-field friendly."""
        return [self.trace_id, self.span_id]

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            # legacy single-parent view + the fan-in truth
            "parent_id": self.parent_ids[0] if self.parent_ids else 0,
            "parent_ids": list(self.parent_ids),
            "name": self.name,
            "start": self.wall,
            "duration_ms": (self.end - self.start) * 1000
            if self.end else None,
            "events": [name for _t, name in self.events],
            "timeline": [(round(t * 1000, 6), name)
                         for t, name in self.events],
            "tags": dict(self.tags),
            "amortized_over": self.amortized_over,
        }

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.finish()
        return False


# -- creation ---------------------------------------------------------------

def _sample_root() -> bool:
    global _sample_tick
    m = mode()
    if m == "off":
        return False
    if m == "full":
        _counters["sampled_roots"] += 1
        return True
    _sample_tick += 1
    hit = _sample_tick % _sample_every == 0
    _counters["sampled_roots" if hit else "unsampled_roots"] += 1
    return hit


def new_trace(name: str):
    """Root span of a new trace -- or :data:`NULL_SPAN` when this trace
    loses the sampling roll (the decision then travels with the
    context: unsampled ops carry no wire field and downstream daemons
    spend nothing)."""
    if not _sample_root():
        return NULL_SPAN
    return Span(name)


def join(ctx, name: str, t0: Optional[float] = None):
    """Adopt a wire context: a child span of the remote parent.  A
    None/absent context (unsampled trace or pre-trace peer) costs one
    comparison.  ``t0`` backdates the span start (queue entry)."""
    if ctx is None or mode() == "off":
        return NULL_SPAN
    try:
        trace_id, parent_id = int(ctx[0]), int(ctx[1])
    except (TypeError, ValueError, IndexError):
        return NULL_SPAN
    return Span(name, trace_id=trace_id, parent_ids=(parent_id,), t0=t0)


def batch_span(name: str, parents: Sequence[object]):
    """ONE span for a stage shared by N ops (coalescer batch, fused
    dispatch, corked burst, mesh SPMD dispatch, recovery multi-read):
    child of every sampled parent, ``amortized_over`` = N so per-op
    timelines can claim ``duration / N`` with no double-timing.  With
    zero sampled parents the stage records nothing."""
    real = [p for p in parents if getattr(p, "sampled", False)]
    if not real:
        return NULL_SPAN
    span = Span(name, trace_id=real[0].trace_id,
                parent_ids=tuple(p.span_id for p in real))
    span.amortized_over = max(1, len(parents))
    for p in real:
        # let each op's timeline find its shared stage
        p.tag_set(f"fanin:{name}", span.span_id)
    return span


# -- task-scoped current span ----------------------------------------------

def current():
    """The active span of this task (NULL_SPAN when none)."""
    return _CURRENT.get() or NULL_SPAN


def current_wire():
    span = _CURRENT.get()
    return span.to_wire() if span is not None and span.sampled else None


class use_span:
    """Scope ``span`` as the task-current span (restores on exit; the
    span itself is NOT finished -- pair with ``with span`` when the
    scope is also the span's lifetime)."""

    __slots__ = ("_span", "_token")

    def __init__(self, span):
        self._span = span

    def __enter__(self):
        self._token = _CURRENT.set(
            self._span if getattr(self._span, "sampled", False) else None)
        return self._span

    def __exit__(self, *exc):
        _CURRENT.reset(self._token)
        return False


def event(name: str) -> None:
    """Event on the task-current span (no-op unsampled)."""
    span = _CURRENT.get()
    if span is not None:
        span.event(name)


def tag(key: str, value) -> None:
    span = _CURRENT.get()
    if span is not None:
        span.tag_set(key, value)


# -- collection / forensics -------------------------------------------------

def dump() -> List[dict]:
    with _collector_lock:
        return [s.to_dict() for s in _finished]


def dump_trace(trace_id: int) -> List[dict]:
    """Every collected span of one trace, parents before children where
    the ring preserved order."""
    with _collector_lock:
        return [s.to_dict() for s in _finished if s.trace_id == trace_id]


def dump_slow(limit: Optional[int] = None) -> List[dict]:
    """Slowest retained root spans, worst first."""
    with _collector_lock:
        roots = list(_slow_roots[: limit or _keep_slow])
    return [s.to_dict() for s in roots]


def find_span(span_id: int) -> Optional["Span"]:
    with _collector_lock:
        for s in _finished:
            if s.span_id == span_id:
                return s
    return None


#: friendly names for adjacent-event intervals in an op timeline; any
#: unlisted pair reads "<a>-><b>" (still summing exactly)
_SEGMENT_NAMES = {
    # span start is backdated to queue entry (trace.join t0)
    ("start", "dequeued"): "queue_wait",
    ("queued", "dequeued"): "queue_wait",
    ("dequeued", "started"): "admit_wait",
    ("started", "encode_submit"): "prepare",
    ("encode_submit", "encode_done"): "batch_encode",
    ("decode_submit", "decode_done"): "batch_decode",
    ("encode_done", "fanout_sent"): "fanout_prep",
    ("fanout_sent", "commit"): "wire_commit",
    ("commit", "replied"): "ack",
    ("gather_sent", "gather_done"): "wire_gather",
}


def op_timeline(span) -> dict:
    """Decompose one op span into named latency segments.

    Segments are the deltas between adjacent recorded events (plus a
    leading start gap and trailing finish gap), so they sum EXACTLY to
    the span's end-to-end duration.  A batch interval (the op waited on
    a fan-in stage it shares with N-1 other ops) is split into the op's
    amortized compute share (``fan-in duration / N``, from the linked
    batch span when still collected) and the residual batch wait --
    amortized shares across all N ops sum to the stage once."""
    if isinstance(span, int):
        span = find_span(span)
    if span is None or not getattr(span, "sampled", False):
        return {"segments": [], "total_ms": 0.0}
    total = (span.end or time.monotonic()) - span.start
    points = [(0.0, "start")] + sorted(span.events) + [(total, "end")]
    segments: List[dict] = []
    for (t0, a), (t1, b) in zip(points, points[1:]):
        ms = max(0.0, (t1 - t0) * 1000)
        if ms == 0.0 and (a, b) not in _SEGMENT_NAMES:
            continue
        name = _SEGMENT_NAMES.get((a, b), f"{a}->{b}")
        seg = {"segment": name, "ms": round(ms, 6)}
        if name in ("batch_encode", "batch_decode"):
            fanin_id = span.tags.get("fanin:" + name)
            fanin = find_span(fanin_id) if fanin_id else None
            if fanin is not None:
                share = (fanin.duration * 1000 /
                         max(1, fanin.amortized_over))
                seg["amortized_share_ms"] = round(min(share, ms), 6)
                seg["batch_wait_ms"] = round(
                    max(0.0, ms - seg["amortized_share_ms"]), 6)
                seg["batch_n"] = fanin.amortized_over
        segments.append(seg)
    return {
        "trace_id": span.trace_id,
        "span_id": span.span_id,
        "name": span.name,
        "total_ms": round(total * 1000, 6),
        "segments": segments,
    }
