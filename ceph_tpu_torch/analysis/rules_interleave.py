"""Flow-aware await-interleaving rules (asyncsan).

Three concurrency faults of the messenger and the OSD were of a kind
the per-function pattern rules structurally could not see:

* an innocent-looking ``await`` opened a yield window between the
  OSD's TCP listen and ``host_pool`` -- revived peers' replayed sub-ops
  dispatched into a pool-less shard ("hosts no pool");
* the messenger's receive watermark advanced BEFORE a
  tear-capable await -- a connection dying inside that await marked an
  undelivered message delivered and the reconnect replay skipped it;
* the whole exactly-once effort exists because client-op state
  mutations interleave across awaits.

All three are the same shape: a shared-state invariant that holds only
if no task switch lands inside a region, broken by an await (sometimes
hidden inside a helper).  These rules walk each async function's CFG
(``analysis/cfg.py``) with the module call graph's may-await summaries
(``analysis/callgraph.py``) so a task-switch point is recognized even
when it hides behind a ``self._helper()`` call, while an await of a
helper that provably cannot suspend stays clean.

Rules:

* ``async-rmw-across-await`` -- read-modify-write of ``self.*`` /
  ``global`` state split across a task-switch point: stale-read
  carriers (``v = self.x`` ... yield ... ``self.x = f(v)``), one-statement
  RMWs whose value awaits (``self.x = merge(self.x, await f())``,
  ``self.x += await f()``), and check-then-act (a branch tested on
  ``self.x``, a yield, then a store to ``self.x``).  Spans bridged
  entirely inside one ``async with ...lock:`` block are exempt -- the
  lock IS the sanctioned way to hold state across awaits.
* ``async-lock-across-await`` -- an explicitly acquired lock or
  budget/ledger token (``await x.acquire()``, ``await throttle.get(n)``)
  held across a task-switch point with no try/finally releasing it:
  the failure path leaks the token and every later acquirer parks
  forever.
* ``async-atomic-section`` -- a declared yield-free region (comment
  markers ``cephlint: atomic-section <name>`` ... ``cephlint:
  end-atomic-section``) containing any task-switch point, plus
  malformed marker pairs.  The same declarations are enforced at
  runtime by ``analysis/runtime.py`` under the tests, so the annotation
  is tested, not trusted.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple

from ceph_tpu_torch.analysis import callgraph as callgraph_mod
from ceph_tpu_torch.analysis import cfg as cfg_mod
from ceph_tpu_torch.analysis.core import (SEV_ERROR, FileContext, Finding,
                                    dotted_name, parse_atomic_sections,
                                    rule)

# -- shared helpers --------------------------------------------------------

#: state key: ("self", attr) or ("global", name)
_Key = Tuple[str, str]


def _state_reads(stmt: ast.stmt, globals_: Set[str]) -> Set[_Key]:
    """State keys read anywhere in ``stmt``'s own expressions."""
    out: Set[_Key] = set()
    for node in _own_exprs(stmt):
        if isinstance(node, ast.Attribute) and \
                isinstance(node.ctx, ast.Load) and \
                isinstance(node.value, ast.Name) and \
                node.value.id == "self":
            out.add(("self", node.attr))
        elif isinstance(node, ast.Name) and \
                isinstance(node.ctx, ast.Load) and node.id in globals_:
            out.add(("global", node.id))
    return out


def _own_exprs(stmt: ast.stmt) -> Iterator[ast.AST]:
    """Expression nodes evaluated by ``stmt`` itself (compound bodies
    and nested defs excluded)."""
    for child in ast.iter_child_nodes(stmt):
        if isinstance(child, ast.stmt):
            continue
        for node in ast.walk(child):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                continue
            yield node


def _store_key(target: ast.expr, globals_: Set[str]) -> Optional[_Key]:
    """The state key a store target writes: ``self.x``, ``self.x[k]``,
    or a ``global``-declared name."""
    node = target
    while isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return ("self", node.attr)
    if isinstance(node, ast.Name) and node.id in globals_:
        return ("global", node.id)
    return None


def _stmt_writes(stmt: ast.stmt,
                 globals_: Set[str]) -> List[Tuple[_Key, ast.expr]]:
    """(key, value-expr) for each state store in this statement."""
    out: List[Tuple[_Key, ast.expr]] = []
    if isinstance(stmt, ast.Assign):
        for target in stmt.targets:
            elts = target.elts if isinstance(
                target, (ast.Tuple, ast.List)) else [target]
            for elt in elts:
                key = _store_key(elt, globals_)
                if key is not None:
                    out.append((key, stmt.value))
    elif isinstance(stmt, ast.AugAssign):
        key = _store_key(stmt.target, globals_)
        if key is not None:
            out.append((key, stmt.value))
    elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
        key = _store_key(stmt.target, globals_)
        if key is not None:
            out.append((key, stmt.value))
    return out


def _declared_globals(fn: ast.AST) -> Set[str]:
    out: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Global):
            out.update(node.names)
    return out


def _names_in(expr: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(expr)
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)}


def _mentions_lock(expr: ast.expr) -> bool:
    if isinstance(expr, ast.Call):
        return _mentions_lock(expr.func)
    return dotted_name(expr).rsplit(".", 1)[-1].lower().endswith("lock")


def _lock_span(ctx: FileContext, a: ast.AST, b: ast.AST) -> bool:
    """Both nodes sit inside the SAME ``async with ...lock:`` block --
    the sanctioned hold-state-across-awaits pattern."""
    parents = ctx.parent_map()

    def lock_withs(node: ast.AST) -> List[ast.AST]:
        chain = []
        cur = node
        while cur in parents:
            cur = parents[cur]
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                break
            if isinstance(cur, ast.AsyncWith) and any(
                    _mentions_lock(item.context_expr)
                    for item in cur.items):
                chain.append(cur)
        return chain

    spans_a = lock_withs(a)
    return bool(spans_a) and any(w in lock_withs(b) for w in spans_a)


def _function_cfg_and_yields(graph, info):
    """(cfg, yield statement set) for one async function."""
    fcfg = cfg_mod.build(info.node)
    yields: Set[ast.stmt] = set()
    for stmt in fcfg.stmts:
        if graph.stmt_yield_node(info, stmt) is not None:
            yields.add(stmt)
    return fcfg, yields


# -- rule: read-modify-write across a task-switch point --------------------

@rule(
    "async-rmw-across-await", "async", SEV_ERROR,
    "read-modify-write of self.*/module state split across an await (or "
    "a call to a helper that may await): another task can mutate the "
    "state inside the yield window and the write clobbers it -- the "
    "watermark-ordering class.  Interprocedural: a helper that only "
    "transitively sleeps still counts; an async helper that provably "
    "never yields does not.",
)
def check_rmw_across_await(ctx: FileContext) -> Iterator[Finding]:
    graph = callgraph_mod.get(ctx)
    for info in graph.functions.values():
        if not info.is_async:
            continue
        globals_ = _declared_globals(info.node)
        fcfg, yields = _function_cfg_and_yields(graph, info)
        if not yields:
            continue  # no task-switch point: nothing can interleave

        # carriers: local = <expr reading state key>
        carriers: List[Tuple[str, _Key, ast.stmt]] = []
        guards: List[Tuple[_Key, ast.stmt]] = []
        for stmt in fcfg.stmts:
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name):
                for key in _state_reads(stmt, globals_):
                    carriers.append((stmt.targets[0].id, key, stmt))
            if isinstance(stmt, (ast.If, ast.While)):
                test_reads: Set[_Key] = set()
                for node in ast.walk(stmt.test):
                    if isinstance(node, ast.Attribute) and \
                            isinstance(node.ctx, ast.Load) and \
                            isinstance(node.value, ast.Name) and \
                            node.value.id == "self":
                        test_reads.add(("self", node.attr))
                for key in test_reads:
                    guards.append((key, stmt))

        reported: Set[Tuple[int, str]] = set()

        def report(stmt: ast.stmt, key: _Key, how: str):
            label = key[1] if key[0] == "self" else key[1]
            spell = f"self.{key[1]}" if key[0] == "self" else key[1]
            mark = (stmt.lineno, label)
            if mark in reported:
                return None
            reported.add(mark)
            return ctx.finding(
                "async-rmw-across-await", stmt,
                f"write to {spell} completes a read-modify-write whose "
                f"read happened before a task-switch point ({how}); "
                "another task can update the state inside that window "
                "and this write clobbers it -- recompute from the live "
                "value after the await, hold an asyncio lock across the "
                "span, or declare the region atomic and move the await "
                "out",
            )

        for stmt in fcfg.stmts:
            for key, value in _stmt_writes(stmt, globals_):
                # same-statement: the value both reads the key and
                # crosses a yield before the store lands
                yield_node = graph.expr_yield_node(info, value)
                if yield_node is not None:
                    reads_key = isinstance(stmt, ast.AugAssign) or \
                        key in _state_reads(stmt, globals_)
                    if reads_key:
                        f = report(stmt, key,
                                   "the awaited expression in this very "
                                   "statement")
                        if f:
                            yield f
                        continue
                # a guard on the same key with a YIELD-FREE path into
                # this write is a fresh re-check (the sanctioned
                # re-check-after-await fix): the write acts on live
                # state, not the stale pre-await read
                fresh_check = any(
                    gkey == key and gstmt is not stmt and
                    fcfg.reaches_clean(gstmt, stmt, yields)
                    for gkey, gstmt in guards)
                # carrier pattern: v = f(self.x) ... yield ... self.x = g(v)
                hit = False
                if not fresh_check:
                    value_names = _names_in(value)
                    # a write that ALSO re-reads the key is a fresh
                    # merge (max/extend against the live value), not a
                    # blind clobber of it
                    fresh_merge = key in _state_reads(stmt, globals_) \
                        and not isinstance(stmt, ast.AugAssign)
                    for name, ckey, cstmt in carriers:
                        if fresh_merge or ckey != key or \
                                name not in value_names or cstmt is stmt:
                            continue
                        crossed = fcfg.crosses_yield(
                            cstmt, stmt, yields,
                            start_crossed=graph.stmt_yield_node(
                                info, cstmt) is not None)
                        if crossed and not _lock_span(ctx, cstmt, stmt):
                            f = report(
                                stmt, key,
                                f"read into {name!r} on line "
                                f"{cstmt.lineno}")
                            if f:
                                yield f
                                hit = True
                            break
                if hit or fresh_check:
                    continue
                # check-then-act: `if self.x ...:` ... yield ... store
                for gkey, gstmt in guards:
                    if gkey != key or gstmt is stmt:
                        continue
                    if fcfg.crosses_yield(gstmt, stmt, yields) and \
                            not _lock_span(ctx, gstmt, stmt):
                        f = report(
                            stmt, key,
                            f"guard tested on line {gstmt.lineno}")
                        if f:
                            yield f
                        break


# -- rule: lock/token held across a task-switch point ----------------------

#: awaited ``<base>.get(...)`` counts as a token acquisition only for
#: bases that look like admission budgets (queues also have .get)
_TOKEN_HINTS = ("throttle", "budget", "ledger", "quota")
_LOCK_HINTS = ("lock", "sem", "semaphore")


def _acquisition(stmt: ast.stmt) -> Optional[Tuple[str, ast.AST]]:
    """(dotted base, site node) when this statement acquires a lock or
    admission token it must later release."""
    for node in _own_exprs(stmt):
        if not (isinstance(node, ast.Call) and
                isinstance(node.func, ast.Attribute)):
            continue
        base = dotted_name(node.func.value)
        tail = base.rsplit(".", 1)[-1].lower()
        if node.func.attr == "acquire":
            if any(h in tail for h in _LOCK_HINTS + _TOKEN_HINTS):
                return base, node
        elif node.func.attr == "get":
            if any(h in tail for h in _TOKEN_HINTS):
                return base, node
    return None


def _releases(stmt: ast.stmt, base: str) -> bool:
    for node in _own_exprs(stmt):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in ("release", "put") and \
                dotted_name(node.func.value) == base:
            return True
    return False


def _finally_releases(ctx: FileContext, stmt: ast.stmt, base: str) -> bool:
    """The acquisition is covered by a try/finally that releases: either
    an enclosing Try's finalbody releases, or the statement directly
    following the acquisition is such a Try."""
    parents = ctx.parent_map()

    def final_has_release(try_node: ast.Try) -> bool:
        for inner in try_node.finalbody:
            for sub in ast.walk(inner):
                if isinstance(sub, ast.stmt) and _releases(sub, base):
                    return True
        return False

    cur: ast.AST = stmt
    while cur in parents:
        parent = parents[cur]
        if isinstance(parent, (ast.FunctionDef, ast.AsyncFunctionDef)):
            break
        if isinstance(parent, ast.Try) and cur in parent.body and \
                final_has_release(parent):
            return True
        cur = parent
    # `await x.acquire()` immediately followed by `try: ... finally: release`
    parent = parents.get(stmt)
    body = getattr(parent, "body", None)
    if isinstance(body, list) and stmt in body:
        idx = body.index(stmt)
        if idx + 1 < len(body) and isinstance(body[idx + 1], ast.Try) and \
                final_has_release(body[idx + 1]):
            return True
    return False


@rule(
    "async-lock-across-await", "async", SEV_ERROR,
    "a lock or budget/ledger token is acquired (`await x.acquire()`, "
    "`await throttle.get(n)`) and a task-switch point is reachable "
    "before any release, with no try/finally releasing it: an exception "
    "or cancellation landing in that window leaks the token and every "
    "later acquirer parks forever -- use `async with`, or wrap the span "
    "in try/finally",
)
def check_lock_across_await(ctx: FileContext) -> Iterator[Finding]:
    graph = callgraph_mod.get(ctx)
    for info in graph.functions.values():
        if not info.is_async:
            continue
        fcfg, yields = _function_cfg_and_yields(graph, info)
        if not yields:
            continue
        for stmt in fcfg.stmts:
            acq = _acquisition(stmt)
            if acq is None:
                continue
            base, site = acq
            if _finally_releases(ctx, stmt, base):
                continue
            stops = {s for s in fcfg.stmts if _releases(s, base)}
            hit = fcfg.first_yield_before(stmt, stops, yields)
            if hit is not None:
                yield ctx.finding(
                    "async-lock-across-await", site,
                    f"{base} is held at the task-switch point on line "
                    f"{hit.lineno} with no try/finally release on the "
                    "path; a failure in that window leaks the token "
                    "(use `async with`, or release in a finally)",
                )


# -- rule: declared atomic sections ----------------------------------------

@rule(
    "async-atomic-section", "async", SEV_ERROR,
    "a declared yield-free region (comment markers `cephlint: "
    "atomic-section <name>` ... `cephlint: end-atomic-section`) "
    "contains a task-switch point, or the markers are malformed.  The "
    "declaration is an invariant other code relies on "
    "(listen->host_pool, watermark ordering); the runtime verifier "
    "(analysis/runtime.py) enforces the same contract under the tests.",
)
def check_atomic_sections(ctx: FileContext) -> Iterator[Finding]:
    sections, problems = parse_atomic_sections(ctx.lines)
    for line, message in problems:
        yield Finding("async-atomic-section", ctx.path, line, 0,
                      message, SEV_ERROR)
    if not sections:
        return
    graph = callgraph_mod.get(ctx)
    for info in graph.functions.values():
        if not info.is_async:
            continue
        for node in callgraph_mod._own_nodes(info.node):
            hit_line = getattr(node, "lineno", None)
            if hit_line is None:
                continue
            section = next(
                (s for s in sections if s.start < hit_line < s.end), None)
            if section is None:
                continue
            reason = None
            if isinstance(node, ast.Await):
                target = node.value
                callee = graph._resolve_call(info, target) \
                    if isinstance(target, ast.Call) else None
                if callee is None:
                    reason = "awaits outside-module code"
                else:
                    tinfo = graph.functions.get(callee)
                    if tinfo is None or not tinfo.is_async:
                        reason = f"awaits unresolved callee {callee!r}"
                    elif tinfo.may_await:
                        reason = (f"awaits {callee}(), which may "
                                  "suspend (transitively awaits)")
            elif isinstance(node, (ast.AsyncFor, ast.AsyncWith)):
                reason = "async for/with suspends at the protocol calls"
            if reason is not None:
                yield ctx.finding(
                    "async-atomic-section", node,
                    f"task-switch point inside atomic section "
                    f"{section.name!r} (lines {section.start}-"
                    f"{section.end}): {reason}; the section declares "
                    "this stretch yield-free -- move the await out or "
                    "re-establish the invariant after it",
                )
