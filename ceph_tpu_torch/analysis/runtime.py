"""Runtime atomic-section verifier: the declared invariants, tested.

Port of ``ceph_tpu/analysis/runtime.py``.  The static rule
(``rules_interleave.check_atomic_sections``) proves no *lexical*
task-switch point sits inside a declared atomic section.  This module
closes the loop at runtime so the annotation itself is tested, not
trusted: under the test suite every event loop gets a verifying task
factory whose coroutine shim observes each yield-to-the-loop and walks
the suspended await chain's frames; a frame parked between a section's
markers means a task switch happened inside a region the code declared
switch-free -- recorded as a violation (and attributed to the running
test by the tests' hook).

The shim is a :class:`collections.abc.Coroutine` object, not a
generator: ``asyncio.Task`` takes only coroutines from Python 3.12 on,
and refuses the ``types.coroutine`` generator the JAX package's verifier
wraps each coroutine in.  The shim forwards ``send``/``throw``/``close``
to the coroutine it drives, so a task cancelled before its first step
throws straight into (and so finishes) the inner coroutine.

Cost: one shim object per task and, per yield, a short frame walk with
one dict probe per frame (only files that declare sections are in the
table).  No tracing/profiling hooks, so hot paths are untouched between
yields.

The FaultInjector (``msg/fault.py``) additionally reports every injected
tear (mid-burst connection kill, apply-window primary kill, torn ring
record) via :func:`on_tear`; the verifier then asserts no OTHER task is
suspended inside a section at tear time -- i.e. the tear window crosses
only watermark-safe states.  Since sections are yield-free this can only
fire if the static layer was evaded (dynamic code, monkeypatching),
which is exactly the gap a runtime verifier exists to cover.

``CEPH_TPU_TORCH_ATOMIC_VERIFY=0`` (the ``atomic_verify`` option's
environment layer) turns the test suite's verifier off
(:func:`enabled`).
"""

from __future__ import annotations

import asyncio
import collections.abc
import os
from typing import Dict, List, Optional, Tuple

from ceph_tpu_torch.analysis.core import parse_atomic_sections


class AtomicViolation:
    """One observed task switch inside a declared atomic section."""

    __slots__ = ("section", "path", "line", "task", "note")

    def __init__(self, section: str, path: str, line: int, task: str,
                 note: str):
        self.section = section
        self.path = path
        self.line = line
        self.task = task
        self.note = note

    def __repr__(self) -> str:
        return (f"task {self.task!r} suspended at {self.path}:{self.line} "
                f"inside atomic section {self.section!r} ({self.note})")


class AtomicSectionError(AssertionError):
    """Raised (opt-in) when a task switches inside an atomic section."""


class AtomicVerifier:
    """Section registry + the verifying coroutine shim."""

    def __init__(self, raise_on_violation: bool = False):
        #: realpath -> [(name, start, end)], sorted by start
        self.sections: Dict[str, List[Tuple[str, int, int]]] = {}
        #: co_filename -> its table (None: no sections), memoized
        self._by_filename: Dict[str, Optional[List[Tuple[str, int, int]]]] = {}
        self.violations: List[AtomicViolation] = []
        self.raise_on_violation = raise_on_violation

    # -- registration ------------------------------------------------------

    def register_source(self, path: str, source: str) -> int:
        """Register every well-formed section declared in ``source``;
        returns how many.  Malformed pairs are the static rule's
        finding, not a runtime concern -- they are skipped here."""
        sections, _problems = parse_atomic_sections(source.splitlines())
        if not sections:
            return 0
        key = os.path.realpath(path)
        table = self.sections.setdefault(key, [])
        self._by_filename.clear()  # a miss may be a hit now
        for s in sections:
            table.append((s.name, s.start, s.end))
        table.sort(key=lambda t: t[1])
        return len(sections)

    def register_file(self, path: str) -> int:
        try:
            with open(path, encoding="utf-8") as fh:
                source = fh.read()
        except OSError:
            return 0
        if "atomic-section" not in source:
            return 0  # cheap pre-filter: most files declare nothing
        return self.register_source(path, source)

    def register_tree(self, root: str) -> int:
        total = 0
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = [d for d in dirnames
                           if d not in ("__pycache__", ".git")]
            for fn in filenames:
                if fn.endswith(".py"):
                    total += self.register_file(os.path.join(dirpath, fn))
        return total

    # -- the check ---------------------------------------------------------

    def _hit(self, filename: str,
             lineno: int) -> Optional[Tuple[str, int, int]]:
        try:
            table = self._by_filename[filename]
        except KeyError:
            # resolve each spelling the interpreter uses once: a miss
            # (most frames) must not cost a realpath on every yield
            table = self.sections.get(filename)
            if table is None:
                table = self.sections.get(os.path.realpath(filename))
            self._by_filename[filename] = table
        if table is None:
            return None
        for name, start, end in table:
            if start < lineno < end:
                return name, start, end
        return None

    def _record(self, section: str, path: str, line: int,
                note: str) -> None:
        task = asyncio.current_task()
        v = AtomicViolation(section, path, line,
                            task.get_name() if task else "<no task>", note)
        self.violations.append(v)
        if self.raise_on_violation:
            raise AtomicSectionError(repr(v))

    def check_awaitable(self, coro, note: str) -> None:
        """Walk a suspended coroutine's await chain; record a violation
        for every frame parked inside a registered section."""
        cur = coro
        for _ in range(64):  # chain-depth bound (cycles are impossible,
            # but a bound keeps the shim's worst case flat)
            if isinstance(cur, VerifyingCoroutine):
                # the verifying shim itself (a task's outermost
                # awaitable when walked from Task.get_coro() in the tear
                # sweep, or a shim awaited directly): bridge into the
                # coroutine it drives
                cur = cur.inner
            frame = getattr(cur, "cr_frame", None)
            if frame is None:
                frame = getattr(cur, "gi_frame", None)
            if frame is None:
                return
            hit = self._hit(frame.f_code.co_filename, frame.f_lineno)
            if hit is not None:
                self._record(hit[0], frame.f_code.co_filename,
                             frame.f_lineno, note)
            nxt = getattr(cur, "cr_await", None)
            if nxt is None:
                nxt = getattr(cur, "gi_yieldfrom", None)
            if nxt is None:
                return
            cur = nxt

    def check_all_tasks(self, note: str) -> None:
        """Tear-time sweep: no task may be parked inside a section when
        an injected fault fires (watermark-safe tear states only)."""
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return
        current = asyncio.current_task(loop)
        for task in asyncio.all_tasks(loop):
            if task is current or task.done():
                continue
            coro = task.get_coro()
            if coro is not None:
                self.check_awaitable(coro, note)

    # -- the shim ----------------------------------------------------------

    def wrap(self, coro):
        """A pass-through driver for ``coro`` that inspects the await
        chain at every yield-to-the-loop."""
        if not asyncio.iscoroutine(coro) or \
                isinstance(coro, VerifyingCoroutine):
            return coro
        return VerifyingCoroutine(self, coro)

    def install(self, loop: asyncio.AbstractEventLoop) -> None:
        verifier = self

        def factory(loop_, coro, **kwargs):
            wrapped = verifier.wrap(coro)
            task = asyncio.Task(wrapped, loop=loop_, **kwargs)
            if wrapped is not coro:
                # a task dropped before it ever steps (its loop closed
                # first) would leave the inner coroutine un-started ->
                # RuntimeWarning at GC.  Close it once the task is done;
                # close() on a finished coroutine is a no-op.
                task.add_done_callback(lambda _t: wrapped.close())
            return task

        loop.set_task_factory(factory)


class VerifyingCoroutine(collections.abc.Coroutine):
    """The verifier's coroutine shim: drives ``inner`` step by step and
    walks its await chain each time it yields to the loop.  A
    :class:`collections.abc.Coroutine`, so ``asyncio.Task`` and ``await``
    both take it; other attributes (``cr_frame``, ``cr_await``,
    ``__qualname__`` ...) are the inner coroutine's."""

    __slots__ = ("_verifier", "inner")

    def __init__(self, verifier: AtomicVerifier, inner):
        self._verifier = verifier
        self.inner = inner

    def _observed(self, yielded):
        # the inner coroutine is suspended at a real yield: this is the
        # only moment another task can run
        self._verifier.check_awaitable(self.inner,
                                       "yield observed by verifier")
        return yielded

    def send(self, value):
        return self._observed(self.inner.send(value))

    def __next__(self):
        return self.send(None)

    def throw(self, typ, val=None, tb=None):
        if val is None and tb is None:
            return self._observed(self.inner.throw(typ))
        return self._observed(self.inner.throw(typ, val, tb))

    def close(self):
        self.inner.close()

    def __await__(self):
        return self

    def __iter__(self):
        return self

    def __getattr__(self, name):
        # cr_frame, cr_await, cr_code, __qualname__ ...: the inner
        # coroutine's, so task reprs and stacks read the real code
        if name == "inner":
            raise AttributeError(name)
        return getattr(self.inner, name)


#: process-global verifier (the port's test helper installs it); tests
#: that provoke violations on purpose build private instances instead
_GLOBAL: Optional[AtomicVerifier] = None


def global_verifier() -> Optional[AtomicVerifier]:
    return _GLOBAL


def violations() -> List[AtomicViolation]:
    return list(_GLOBAL.violations) if _GLOBAL is not None else []


def register_default_sections(verifier: AtomicVerifier) -> int:
    """Register every section declared under the ceph_tpu_torch package,
    its ``tools/`` included (the scan is one substring probe per
    file)."""
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return verifier.register_tree(pkg_root)


#: the ``atomic_verify`` option's environment layer
ENABLE_ENV = "CEPH_TPU_TORCH_ATOMIC_VERIFY"


def enabled() -> bool:
    """Whether the test suite installs the verifier (on unless
    ``CEPH_TPU_TORCH_ATOMIC_VERIFY=0``)."""
    return os.environ.get(ENABLE_ENV, "1") not in ("0", "false", "off")


class VerifyingPolicy(asyncio.DefaultEventLoopPolicy):
    """Event-loop policy whose loops carry the verifying task factory
    (covers ``asyncio.run`` and ``asyncio.new_event_loop`` both)."""

    def __init__(self, verifier: AtomicVerifier):
        super().__init__()
        self._verifier = verifier

    def new_event_loop(self):
        loop = super().new_event_loop()
        self._verifier.install(loop)
        return loop


def install() -> AtomicVerifier:
    """Install the global verifier (idempotent): registers the port's
    declared sections and routes every future event loop through the
    verifying task factory."""
    global _GLOBAL
    if _GLOBAL is None:
        _GLOBAL = AtomicVerifier()
        register_default_sections(_GLOBAL)
        asyncio.set_event_loop_policy(VerifyingPolicy(_GLOBAL))
    return _GLOBAL


def on_tear(kind: str) -> None:
    """FaultInjector hook: an injected tear (connection kill, apply-
    window primary kill) just fired; assert no task is parked inside an
    atomic section (the tear crosses only watermark-safe states)."""
    if _GLOBAL is not None:
        _GLOBAL.check_all_tasks(f"injected tear ({kind})")
