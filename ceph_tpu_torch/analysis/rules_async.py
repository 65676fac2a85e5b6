"""Async hygiene rules (the tick-loop wedge class and its relatives).

The motivating fault: a messenger tick loop whose ``create_task``
result was dropped -- cancellation raced a ``wait_for`` (bpo-42130),
the lone cancel was swallowed, and the immortal loop wedged the whole
test suite.  Every rule here is a mechanically-detectable face of that
fault class.  The rules read only the AST, so they are the JAX
package's rules unchanged: on the same source both give the same
findings.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional, Set

from ceph_tpu_torch.analysis.core import (SEV_ERROR, SEV_WARNING, FileContext,
                                    Finding, call_attr, call_name,
                                    in_async_context, rule)

_SPAWN_ATTRS = {"create_task", "ensure_future"}

#: call targets that block the event loop when made from a coroutine
_BLOCKING_CALLS = {
    "time.sleep": "use `await asyncio.sleep(...)`",
    "subprocess.run": "use `asyncio.create_subprocess_exec` or an executor",
    "subprocess.call": "use `asyncio.create_subprocess_exec` or an executor",
    "subprocess.check_call": "use `asyncio.create_subprocess_exec` or an "
                             "executor",
    "subprocess.check_output": "use `asyncio.create_subprocess_exec` or an "
                               "executor",
    "os.system": "use `asyncio.create_subprocess_shell` or an executor",
    "os.popen": "use `asyncio.create_subprocess_shell` or an executor",
}


@rule(
    "async-orphan-task", "async", SEV_ERROR,
    "create_task/ensure_future result dropped: without a retained "
    "reference the task is garbage-collectable mid-flight, and without a "
    "done-callback its exception (or survival across shutdown) is "
    "invisible -- the tick-loop wedge class",
)
def check_orphan_task(ctx: FileContext) -> Iterator[Finding]:
    if not any(attr in ctx.source for attr in _SPAWN_ATTRS):
        return  # no spawn spelled anywhere in the file
    for node in ctx.walk():
        # a spawn whose value is the whole statement: nothing retained
        if isinstance(node, ast.Expr) and isinstance(node.value, ast.Call) \
                and call_attr(node.value) in _SPAWN_ATTRS:
            yield ctx.finding(
                "async-orphan-task", node,
                f"result of {call_name(node.value)}(...) is dropped; "
                "retain it (e.g. messenger.adopt_task) or attach a "
                "done-callback that logs exceptions",
            )
        # an awaited spawn is pointless but not an orphan; skip


def _scope_defs(ctx: FileContext):
    """Lexical name tables: (scope node -> {fn name: is_async}) for
    module/function scopes, plus {method name: is_async} for methods
    (a name defined as BOTH sync and async method anywhere stays
    ambiguous and is dropped -- no types here)."""
    parents = ctx.parent_map()
    scopes: dict = {}
    methods: dict = {}
    for node in ctx.walk():
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        parent = parents.get(node, ctx.tree)
        is_async = isinstance(node, ast.AsyncFunctionDef)
        if isinstance(parent, ast.ClassDef):
            if node.name in methods and methods[node.name] != is_async:
                methods[node.name] = None  # ambiguous across classes
            else:
                methods.setdefault(node.name, is_async)
        # the scope a def's NAME lives in: its innermost enclosing
        # function, else the module
        scope: ast.AST = ctx.tree
        cur = node
        while cur in parents:
            cur = parents[cur]
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scope = cur
                break
        scopes.setdefault(scope, {})[node.name] = is_async
    return scopes, methods


@rule(
    "async-unawaited-coroutine", "async", SEV_ERROR,
    "bare call to a coroutine function defined in this module: the "
    "coroutine object is created and silently discarded, the body never "
    "runs (RuntimeWarning at best)",
)
def check_unawaited_coroutine(ctx: FileContext) -> Iterator[Finding]:
    from ceph_tpu_torch.analysis.core import enclosing_functions

    scopes, methods = _scope_defs(ctx)
    if not scopes and not methods:
        return
    for node in ctx.walk():
        if not (isinstance(node, ast.Expr) and
                isinstance(node.value, ast.Call)):
            continue
        func = node.value.func
        is_async = None
        name = None
        if isinstance(func, ast.Name):
            # resolve lexically, innermost scope outward (a nested
            # `async def run` must not taint an outer sync `run`)
            name = func.id
            for scope in reversed(
                    [ctx.tree] + enclosing_functions(ctx, node)):
                if name in scopes.get(scope, {}):
                    is_async = scopes[scope][name]
                    break
        elif isinstance(func, ast.Attribute) and \
                isinstance(func.value, ast.Name) and func.value.id == "self":
            name = func.attr
            is_async = methods.get(name)
        if is_async:
            yield ctx.finding(
                "async-unawaited-coroutine", node,
                f"coroutine {name}(...) is neither awaited nor spawned; "
                "the call creates a coroutine object and drops it",
            )


@rule(
    "async-blocking-call", "async", SEV_WARNING,
    "blocking call inside `async def` stalls the whole event loop (every "
    "dispatch loop, tick and client op on it)",
)
def check_blocking_call(ctx: FileContext) -> Iterator[Finding]:
    for node in ctx.walk():
        if not isinstance(node, ast.Call):
            continue
        if not in_async_context(ctx, node):
            continue
        name = call_name(node)
        if name in _BLOCKING_CALLS:
            yield ctx.finding(
                "async-blocking-call", node,
                f"{name}(...) blocks the event loop; "
                f"{_BLOCKING_CALLS[name]}",
            )
        elif name == "open":
            yield ctx.finding(
                "async-blocking-call", node,
                "sync file I/O (`open`) inside `async def` blocks the "
                "event loop; move it to `loop.run_in_executor` (or do it "
                "before entering async context)",
            )


@rule(
    "async-drain-per-item", "async", SEV_WARNING,
    "`await writer.drain()` inside a per-item loop that also writes: "
    "one flush (and its coroutine round) per message is the classic "
    "small-message wire overhead -- batch the writes (writelines) and "
    "drain once per burst, or drain on a byte threshold (flow control), "
    "the round-8 corked-messenger discipline",
)
def check_drain_per_item(ctx: FileContext) -> Iterator[Finding]:
    from ceph_tpu_torch.analysis.core import enclosing_functions

    parents = ctx.parent_map()

    def innermost_loop(node, holder):
        """Nearest enclosing loop of ``node`` within the same function
        (a nested def's body does not run under the outer loop)."""
        cur = node
        while cur in parents:
            cur = parents[cur]
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return None
            if isinstance(cur, (ast.For, ast.AsyncFor, ast.While)):
                return cur
        return None

    for node in ctx.walk():
        if not (isinstance(node, ast.Await) and
                isinstance(node.value, ast.Call) and
                call_attr(node.value) == "drain"):
            continue
        loop = innermost_loop(node, None)
        if loop is None:
            continue
        holder = enclosing_functions(ctx, node)
        # per-ITEM: the same innermost loop body performs a unit
        # `.write(...)` -- a loop that only writelines per burst, or
        # whose writes happen in a nested (inner) loop with the drain
        # outside it, is the per-burst shape and stays clean
        for inner in ast.walk(loop):
            if isinstance(inner, ast.Call) and \
                    call_attr(inner) == "write" and \
                    innermost_loop(inner, None) is loop and \
                    enclosing_functions(ctx, inner) == holder:
                yield ctx.finding(
                    "async-drain-per-item", node,
                    "await drain() and a per-item write share this loop "
                    "body; cork the writes (writer.writelines once per "
                    "burst) and drain per burst or on a byte threshold",
                )
                break
        # one finding per drain site is enough


#: awaited call targets that pace a retry loop (sleep/backoff, event or
#: queue parks, deadline-capped waits) -- any one of them in the loop
#: body means the loop is not a hot blind-retry spin
_PACING_ATTRS = {"sleep", "wait", "wait_for", "get", "gather", "acquire"}


def _names_deadline(node: ast.AST) -> bool:
    """A comparison/name that consults a deadline: any identifier
    containing 'deadline'/'timeout', or a ``.time()`` call (loop clock
    reads exist only to be compared against a budget)."""
    for inner in ast.walk(node):
        if isinstance(inner, ast.Name) and (
            "deadline" in inner.id.lower() or "timeout" in inner.id.lower()
        ):
            return True
        if isinstance(inner, ast.Attribute) and (
            "deadline" in inner.attr.lower() or "timeout" in inner.attr.lower()
        ):
            return True
        if isinstance(inner, ast.Call) and call_attr(inner) == "time":
            return True
    return False


@rule(
    "async-unbounded-retry", "async", SEV_WARNING,
    "`while True` retry loop (an except handler that `continue`s) with "
    "no deadline check and no awaited backoff/park in the body: on a "
    "persistent failure it spins the event loop forever and hammers "
    "whatever it is retrying against -- the failure mode the Objecter's "
    "deadline-aware jittered backoff exists to prevent",
)
def check_unbounded_retry(ctx: FileContext) -> Iterator[Finding]:
    from ceph_tpu_torch.analysis.core import enclosing_functions

    parents = ctx.parent_map()

    def innermost_loop(node):
        cur = node
        while cur in parents:
            cur = parents[cur]
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return None
            if isinstance(cur, (ast.For, ast.AsyncFor, ast.While)):
                return cur
        return None

    for node in ctx.walk():
        if not isinstance(node, ast.While):
            continue
        test = node.test
        if not (isinstance(test, ast.Constant) and test.value in (True, 1)):
            continue
        if not in_async_context(ctx, node):
            continue
        holder = enclosing_functions(ctx, node)
        # retry signature: an except handler in THIS loop whose body
        # continues the loop (error -> try again)
        retries = False
        for t in ast.walk(node):
            if not isinstance(t, ast.Try) or innermost_loop(t) is not node:
                continue
            for handler in t.handlers:
                for inner in ast.walk(handler):
                    if isinstance(inner, ast.Continue) and \
                            innermost_loop(inner) is node and \
                            enclosing_functions(ctx, inner) == holder:
                        retries = True
        if not retries:
            continue
        # pacing / deadline evidence anywhere in the loop body (same
        # function): an awaited sleep/park, or a deadline consult
        paced = False
        for inner in ast.walk(node):
            if enclosing_functions(ctx, inner) != holder:
                continue
            if isinstance(inner, ast.Await) and \
                    isinstance(inner.value, ast.Call):
                tail = call_attr(inner.value) or \
                    call_name(inner.value).rsplit(".", 1)[-1]
                if tail in _PACING_ATTRS:
                    paced = True
                    break
            if isinstance(inner, (ast.If, ast.Compare)) and \
                    _names_deadline(inner):
                paced = True
                break
        if not paced:
            yield ctx.finding(
                "async-unbounded-retry", node,
                "retry loop without a deadline or backoff: add a "
                "deadline check (fail the op when the budget is spent) "
                "and an awaited, ideally jittered-exponential, delay "
                "between attempts",
            )


#: iterable names that mark a per-client/per-op scale collection --
#: the million-client rule (substring match on the last dotted part):
#: fanning one coroutine/task per element of one of these without a
#: budget admit is exactly how a scale harness OOMs itself
_FANOUT_COLLECTION_MARKS = (
    "client", "conn", "session", "objecter", "peer", "request",
    "waiter", "op_list", "ops", "oids",
)
#: budget evidence: an awaited acquire/admit (semaphore, throttle,
#: QoS admission) or a Semaphore/budget construction in the function
_FANOUT_BUDGET_ATTRS = {"acquire", "admit", "slot", "get"}


def _fanout_collection_name(node: ast.expr) -> Optional[str]:
    """The iterated collection's name when it looks like an unbounded
    client/op set (``self.clients``, ``conns``, ...); None for
    literals, ``range(...)`` worker pools and unmarked names."""
    from ceph_tpu_torch.analysis.core import dotted_name

    if isinstance(node, ast.Call):
        return None  # range(n)/sorted(...) worker-pool shapes
    name = dotted_name(node).rsplit(".", 1)[-1].lower()
    if not name:
        return None
    for mark in _FANOUT_COLLECTION_MARKS:
        if mark in name:
            return name
    return None


def _has_budget_evidence(fn: ast.AST, ctx: FileContext, holder) -> bool:
    """An awaited acquire/admit/slot, a Semaphore construction, or a
    budget-named attribute in ``fn`` (same function scope)."""
    from ceph_tpu_torch.analysis.core import dotted_name, enclosing_functions

    for inner in ast.walk(fn):
        if isinstance(inner, ast.Call):
            tail = dotted_name(inner.func).rsplit(".", 1)[-1]
            if tail in ("Semaphore", "BoundedSemaphore", "Throttle"):
                return True
        if isinstance(inner, ast.Await) and \
                isinstance(inner.value, ast.Call) and \
                enclosing_functions(ctx, inner) == holder:
            attr = call_attr(inner.value)
            if attr in _FANOUT_BUDGET_ATTRS:
                return True
            tgt = dotted_name(inner.value.func).lower()
            if "budget" in tgt or "throttle" in tgt or "admit" in tgt:
                return True
        if isinstance(inner, (ast.Attribute, ast.Name)):
            nm = dotted_name(inner).rsplit(".", 1)[-1].lower()
            if "budget" in nm or "_sem" in nm or nm.endswith("sem"):
                return True
    return False


@rule(
    "async-unbounded-fanout", "async", SEV_WARNING,
    "gather/spawn fan-out over an unbounded client/op collection with "
    "no semaphore/budget admit in scope: at a thousand clients the "
    "coroutine set IS the memory bound, and at a million it is an OOM "
    "-- acquire a budget permit per element (the loadgen "
    "per-client in-flight budget discipline) or bound the pool "
    "(fixed worker count over a queue)",
)
def check_unbounded_fanout(ctx: FileContext) -> Iterator[Finding]:
    from ceph_tpu_torch.analysis.core import enclosing_functions

    for fn in ctx.walk():
        if not isinstance(fn, ast.AsyncFunctionDef):
            continue
        budget_known: Optional[bool] = None
        for node in ast.walk(fn):
            # only a gather() call or a for-loop can be a fan-out site:
            # test that before the (costlier) enclosing-function walk
            if not (isinstance(node, (ast.For, ast.AsyncFor)) or
                    (isinstance(node, ast.Call) and
                     (call_attr(node) == "gather" or
                      call_name(node) == "gather"))):
                continue
            holder = enclosing_functions(ctx, node)
            if not holder or holder[-1] is not fn:
                continue
            site = None
            coll = None
            # shape 1: gather(*(f(x) for x in CLIENTS)) / gather(*[...])
            if isinstance(node, ast.Call) and (
                    call_attr(node) == "gather" or
                    call_name(node) == "gather"):
                for arg in node.args:
                    gen = None
                    if isinstance(arg, ast.Starred):
                        gen = arg.value
                    if isinstance(gen, (ast.GeneratorExp, ast.ListComp)):
                        per_item = any(
                            isinstance(x, ast.Call)
                            for x in ast.walk(gen.elt))
                        if per_item and gen.generators:
                            coll = _fanout_collection_name(
                                gen.generators[0].iter)
                            site = node
            # shape 2: for x in CLIENTS: ... create_task(f(x)) ...
            elif isinstance(node, (ast.For, ast.AsyncFor)):
                cname = _fanout_collection_name(node.iter)
                if cname is not None:
                    for inner in ast.walk(node):
                        if isinstance(inner, ast.Call) and \
                                call_attr(inner) in _SPAWN_ATTRS and \
                                enclosing_functions(ctx, inner) == holder:
                            coll = cname
                            site = inner
                            break
            if site is None or coll is None:
                continue
            if budget_known is None:
                budget_known = _has_budget_evidence(fn, ctx, holder)
            if budget_known:
                continue
            yield ctx.finding(
                "async-unbounded-fanout", site,
                f"per-item fan-out over {coll!r} in {fn.name}() with no "
                "semaphore/budget admit in scope; bound it (budget "
                "permit per element, or a fixed worker pool over a "
                "queue)",
            )


def _mentions_lock(node: ast.expr) -> bool:
    """Context-manager expression names a lock: `lock`, `self._lock`,
    `self._conn_lock(node)` ...  The lockdep convention (utils/lockdep)
    is that every lock object's name ends in 'lock'."""
    from ceph_tpu_torch.analysis.core import dotted_name

    if isinstance(node, ast.Call):
        return _mentions_lock(node.func)
    tail = dotted_name(node).rsplit(".", 1)[-1].lower()
    return tail.endswith("lock")


@rule(
    "async-sync-lock-await", "async", SEV_ERROR,
    "await while holding a NON-async lock (`with ...lock:` instead of "
    "`async with`): the awaiting task parks on the loop with the lock "
    "held and every other task that touches it deadlocks -- asyncio "
    "locks (utils/lockdep TrackedLock) are the rail here",
)
def check_sync_lock_await(ctx: FileContext) -> Iterator[Finding]:
    from ceph_tpu_torch.analysis.core import enclosing_functions

    for node in ctx.walk():
        if not isinstance(node, ast.With):  # async with is fine
            continue
        if not any(_mentions_lock(item.context_expr) for item in node.items):
            continue
        holder = enclosing_functions(ctx, node)
        for inner in ast.walk(node):
            # an await inside a NESTED def does not run under this lock
            if isinstance(inner, ast.Await) and \
                    enclosing_functions(ctx, inner) == holder:
                yield ctx.finding(
                    "async-sync-lock-await", inner,
                    "await inside a sync `with ...lock:` block; hold an "
                    "asyncio lock (`async with`) across await points",
                )
                break  # one finding per with-block is enough


#: await targets that move background data (recovery pushes, scrub /
#: gather reads, fan-out commits) -- exact attr-name match
_BG_IO_ATTRS = {
    "send_message", "send_messages", "_fanout_commit", "_read_shards",
    "_gather_consistent", "batched_sub_reads", "batched_pushes",
}
#: awaited attrs that count as admission/pacing between batches
#: (substring match: throttle.admit, _recovery_pace, asyncio.sleep,
#: wait/wait_for parks, semaphore.acquire)
_BG_PACING_MARKS = ("admit", "pace", "sleep", "throttle", "wait",
                    "acquire")
#: function names that mark background-class work
_BG_NAME_MARKS = ("recover", "scrub", "backfill", "background")


@rule(
    "async-background-unthrottled", "async", SEV_WARNING,
    "background-class loop (recovery/backfill/scrub) issues pushes or "
    "gather reads with no opqueue admit and no awaited pacing between "
    "batches: a rebuild storm then competes unboundedly with client "
    "traffic and starves client p99 -- admit through the "
    "BackgroundThrottle (osd/recovery.py) or await pacing "
    "(osd_recovery_sleep) once per batch",
)
def check_background_unthrottled(ctx: FileContext) -> Iterator[Finding]:
    from ceph_tpu_torch.analysis.core import enclosing_functions

    for fn in ctx.walk():
        if not isinstance(fn, ast.AsyncFunctionDef):
            continue
        lname = fn.name.lower()
        if not any(mark in lname for mark in _BG_NAME_MARKS):
            continue
        for loop in ast.walk(fn):
            if not isinstance(loop, (ast.For, ast.AsyncFor, ast.While)):
                continue
            holder = enclosing_functions(ctx, loop)
            if not holder or holder[-1] is not fn:
                continue  # a nested def's loop is its own scope
            first_io = None
            paced = False
            for inner in ast.walk(loop):
                # code inside a nested def does not run under this loop
                if enclosing_functions(ctx, inner) != holder:
                    continue
                if isinstance(inner, ast.Await) and \
                        isinstance(inner.value, ast.Call):
                    attr = call_attr(inner.value)
                    if attr in _BG_IO_ATTRS and first_io is None:
                        first_io = inner
                    elif any(m in attr.lower() for m in _BG_PACING_MARKS):
                        paced = True
                elif isinstance(inner, ast.Call) and \
                        call_attr(inner) == "enqueue":
                    paced = True  # admitted through an op queue
            if first_io is not None and not paced:
                yield ctx.finding(
                    "async-background-unthrottled", first_io,
                    f"loop in background function {fn.name}() awaits "
                    f"{call_attr(first_io.value)}(...) with no throttle "
                    "admit or awaited pacing in the loop body",
                )
