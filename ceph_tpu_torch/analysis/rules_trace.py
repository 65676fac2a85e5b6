"""Observability-hygiene rules.

``trace-span-unfinished``: a started span / TrackedOp with a CFG path
that never reaches ``finish()``.  The round-16 trace subsystem keeps a
live-span map exactly because an unfinished span is silent loss twice
over -- the op never lands in the collector (its trace is a hole) and
the live map grows until the overflow counter starts churning.  The
runtime counterpart (``trace.unfinished_count()``, gated by the
ci_lint traced-op smoke) only sees leaks a workload happens to drive;
this rule walks every function's control-flow graph
(``analysis/cfg.py``) and flags creation sites where SOME path falls
off the function without crossing a ``finish()`` call or a ``with``
block on the span.

Ownership transfer is respected: a span that escapes the function
(returned, yielded, passed to another call, stored into state or a
container, aliased) is the receiver's to finish -- the optracker's
``create_request(span=...)`` hand-off and the OSD's tracked-op
plumbing are exactly this shape.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set

from ceph_tpu_torch.analysis import cfg as cfg_mod
from ceph_tpu_torch.analysis.core import (SEV_WARNING, FileContext, Finding,
                                    call_attr, call_name, rule)

#: call attrs that mint a span/TrackedOp the caller must close.  A bare
#: ``child()`` is excluded: too generic an attr name to match without
#: type inference (child spans ride ``with`` blocks in practice).
_SPAN_CREATORS = {"new_trace", "batch_span"}
_TRACKER_CREATOR = "create_request"


def _own_nodes(fn: ast.AST) -> Iterator[ast.AST]:
    """Every AST node of ``fn``'s own body, nested defs excluded (their
    spans have their own CFG and their own rule pass)."""
    stack: List[ast.AST] = list(fn.body)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _is_creator(call: ast.Call) -> bool:
    attr = call_attr(call)
    if attr in _SPAN_CREATORS:
        return True
    if attr == _TRACKER_CREATOR:
        # require a tracker-ish receiver so unrelated create_request
        # APIs (none in-tree today) cannot false-positive
        return "tracker" in call_name(call).lower()
    return False


def _escapes(ctx: FileContext, fn: ast.AST, var: str,
             creation: ast.Call) -> bool:
    """True when ``var`` leaves the function's hands: returned, passed,
    stored, aliased, or placed in a container -- ownership (and the
    finish obligation) moved with it."""
    parents = ctx.parent_map()
    for node in _own_nodes(fn):
        if not (isinstance(node, ast.Name) and node.id == var and
                isinstance(node.ctx, ast.Load)):
            continue
        parent = parents.get(node)
        if isinstance(parent, ast.Attribute):
            continue  # x.method()/x.attr: plain use
        if isinstance(parent, (ast.Return, ast.Yield, ast.YieldFrom)):
            return True
        if isinstance(parent, ast.Call):
            return True  # positional arg (x.m() parents as Attribute)
        if isinstance(parent, ast.keyword):
            return True
        if isinstance(parent, (ast.Assign, ast.AugAssign,
                               ast.AnnAssign, ast.NamedExpr)):
            return True  # aliased or stored somewhere
        if isinstance(parent, (ast.List, ast.Tuple, ast.Set, ast.Dict,
                               ast.Starred)):
            return True
        if isinstance(parent, ast.withitem):
            continue  # `with x:` is the cleanup idiom, handled below
        if isinstance(parent, (ast.Compare, ast.BoolOp, ast.UnaryOp,
                               ast.IfExp, ast.If, ast.While,
                               ast.FormattedValue, ast.Expr,
                               ast.Subscript, ast.Await, ast.Assert)):
            continue  # truthiness / formatting / indexing: plain use
        return True  # unknown context: assume a hand-off (no false
        #              positives from contexts this walk cannot judge)
    return False


def _header_exprs(stmt: ast.stmt) -> Iterator[ast.AST]:
    """Expressions evaluated BY this CFG node itself: a compound
    statement's nested blocks are separate CFG nodes, so a finish()
    buried in one branch must not make the whole If a closer."""
    for child in ast.iter_child_nodes(stmt):
        if isinstance(child, (ast.stmt, ast.ExceptHandler)):
            continue
        for node in ast.walk(child):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda, ast.ClassDef)):
                break
            yield node


def _closing_stmts(cfg: "cfg_mod.CFG", var: str) -> Set[ast.stmt]:
    """Statements that discharge the finish obligation: a ``finish()``
    call on ``var``, or a ``with var`` block (``__exit__`` finishes)."""
    out: Set[ast.stmt] = set()
    for stmt in cfg.stmts:
        if isinstance(stmt, (ast.With, ast.AsyncWith)) and any(
            isinstance(item.context_expr, ast.Name) and
            item.context_expr.id == var
            for item in stmt.items
        ):
            out.add(stmt)
            continue
        for node in _header_exprs(stmt):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "finish" and \
                    isinstance(node.func.value, ast.Name) and \
                    node.func.value.id == var:
                out.add(stmt)
                break
    return out


def _leaks(cfg: "cfg_mod.CFG", creation: ast.stmt,
           closers: Set[ast.stmt]) -> bool:
    """True when some path creation -> ... -> EXIT crosses no closer."""
    seen: Set[int] = set()
    frontier: List[object] = list(cfg.succ.get(creation, []))
    while frontier:
        node = frontier.pop()
        if node is cfg_mod.EXIT:
            return True
        if id(node) in seen or node in closers:
            continue
        seen.add(id(node))
        frontier.extend(cfg.succ.get(node, []))
    return False


@rule(
    "trace-span-unfinished", "ceph", SEV_WARNING,
    "a span/TrackedOp minted by new_trace()/batch_span()/"
    "create_request() has a control-flow path that exits the function "
    "without finish() (or a `with` block): the op never reaches the "
    "collector and the live-span map leaks -- finish in a try/finally, "
    "use the span as a context manager, or hand ownership off "
    "explicitly (return/store/pass it)",
)
def check_span_unfinished(ctx: FileContext) -> Iterator[Finding]:
    if not any(c in ctx.source
               for c in (*_SPAN_CREATORS, _TRACKER_CREATOR)):
        return  # no creator spelled anywhere in the file
    for fn in ctx.walk():
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        creations = []
        for stmt in _own_nodes(fn):
            if isinstance(stmt, ast.Assign) and \
                    len(stmt.targets) == 1 and \
                    isinstance(stmt.targets[0], ast.Name) and \
                    isinstance(stmt.value, ast.Call) and \
                    _is_creator(stmt.value):
                creations.append((stmt, stmt.targets[0].id))
        if not creations:
            continue
        graph: Optional[cfg_mod.CFG] = None
        closers_by_var: Dict[str, Set[ast.stmt]] = {}
        for stmt, var in creations:
            if _escapes(ctx, fn, var, stmt.value):
                continue
            if graph is None:
                graph = cfg_mod.build(fn)
            closers = closers_by_var.get(var)
            if closers is None:
                closers = closers_by_var[var] = _closing_stmts(
                    graph, var)
            if stmt in closers:
                # `x = creator(); x.finish()` folded into one statement
                # cannot happen for an Assign, but a closer that IS the
                # creation would wrongly discharge itself
                closers = closers - {stmt}
            if _leaks(graph, stmt, closers):
                yield ctx.finding(
                    "trace-span-unfinished", stmt,
                    f"span '{var}' from {call_name(stmt.value)}() can "
                    "reach function exit without finish(): the trace "
                    "loses the op and the live-span map leaks; close "
                    "it in a try/finally or a `with` block (escaping "
                    "spans -- returned/stored/passed -- are exempt)",
                )
