"""Statement-level control-flow graphs for the flow-aware rules.

One CFG per function definition.  Nodes are the function's own
``ast.stmt`` objects (compound headers -- ``if``/``while``/``for``/
``try``/``with`` -- are nodes carrying their test/iter/items
expressions; their block bodies are separate nodes).  Edges follow the
usual approximations:

* loops get a body edge, a fall-through edge (taken even for
  ``while True`` only when the test is non-constant) and a back edge;
* every statement inside a ``try`` body may raise into each handler
  (call-free statements too -- the cheap over-approximation);
* ``return`` goes to EXIT -- through the enclosing ``finally`` block
  first when there is one (the finalbody runs on the way out, so a
  cleanup statement there IS on every return path); ``raise`` goes to
  the innermost handlers (or EXIT), ``break``/``continue`` to their
  loop targets.

The rules ask one kind of question: *can execution flow from statement
A to statement B, and does some such path cross a task-switch point?*
:meth:`CFG.crosses_yield` answers it with a BFS over ``(node,
crossed)`` states, where the yield set comes from the call graph's
may-await classification -- so an ``await self._pure_helper()`` on the
path does not count as an interleaving window but an
``await self._helper_that_drains()`` does.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

#: graph sink: returns, final statements, uncaught raises
EXIT = "<exit>"


class CFG:
    """Control-flow graph over one function's statements."""

    def __init__(self, fn: ast.AST):
        self.fn = fn
        self.succ: Dict[object, List[object]] = {}
        self.stmts: List[ast.stmt] = []
        self._stmt_set: Set[int] = set()
        entry = self._block(fn.body, [EXIT], [], [], [EXIT], [EXIT])
        self.entry: List[object] = entry

    # -- construction ------------------------------------------------------

    def _add(self, node: ast.stmt) -> None:
        if id(node) not in self._stmt_set:
            self._stmt_set.add(id(node))
            self.stmts.append(node)
            self.succ.setdefault(node, [])

    def _edge(self, src: ast.stmt, dsts: Iterable[object]) -> None:
        out = self.succ.setdefault(src, [])
        for d in dsts:
            if all(d is not e for e in out):
                out.append(d)

    def _block(self, stmts: Sequence[ast.stmt], follow: List[object],
               breaks: List[object], continues: List[object],
               raises: List[object],
               returns: List[object]) -> List[object]:
        """Wire a statement list; returns the block's entry points.
        ``returns`` is where a ``return`` statement flows: EXIT
        normally, the enclosing ``finally`` block's entry inside a
        try/finally (the finalbody runs before the function leaves)."""
        if not stmts:
            return list(follow)
        entries: Optional[List[object]] = None
        # wire back-to-front so each statement knows its successor entry
        nxt: List[object] = list(follow)
        for stmt in reversed(stmts):
            nxt = self._stmt(stmt, nxt, breaks, continues, raises, returns)
        entries = nxt
        return entries

    def _stmt(self, stmt: ast.stmt, follow: List[object],
              breaks: List[object], continues: List[object],
              raises: List[object], returns: List[object]) -> List[object]:
        """Wire one statement; returns its entry points (usually just
        ``[stmt]``)."""
        self._add(stmt)
        if isinstance(stmt, ast.If):
            body = self._block(stmt.body, follow, breaks, continues, raises,
                               returns)
            orelse = self._block(stmt.orelse, follow, breaks, continues,
                                 raises, returns) \
                if stmt.orelse else list(follow)
            self._edge(stmt, body)
            self._edge(stmt, orelse)
        elif isinstance(stmt, (ast.While,)):
            body = self._block(stmt.body, [stmt], follow, [stmt], raises,
                               returns)
            self._edge(stmt, body)
            test = stmt.test
            infinite = isinstance(test, ast.Constant) and bool(test.value)
            if not infinite or stmt.orelse:
                self._edge(stmt, self._block(
                    stmt.orelse, follow, breaks, continues, raises, returns)
                    if stmt.orelse else follow)
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            body = self._block(stmt.body, [stmt], follow, [stmt], raises,
                               returns)
            self._edge(stmt, body)
            self._edge(stmt, self._block(
                stmt.orelse, follow, breaks, continues, raises, returns)
                if stmt.orelse else follow)
        elif isinstance(stmt, ast.Try):
            handler_entries: List[object] = []
            final_entry = self._block(
                stmt.finalbody, follow, breaks, continues, raises, returns) \
                if stmt.finalbody else list(follow)
            # a `return` under this try runs the finalbody on the way
            # out, so it routes through final_entry, not straight to
            # EXIT (over-approximated: the finalbody's fall-through
            # edge to `follow` survives, which is the safe direction
            # for every may-reach query)
            inner_returns = final_entry if stmt.finalbody else returns
            for handler in stmt.handlers:
                handler_entries.extend(self._block(
                    handler.body, final_entry, breaks, continues, raises,
                    inner_returns))
            inner_raises = handler_entries or final_entry or list(raises)
            after_body = self._block(
                stmt.orelse, final_entry, breaks, continues, raises,
                inner_returns) \
                if stmt.orelse else final_entry
            body = self._block(stmt.body, after_body, breaks, continues,
                               inner_raises, inner_returns)
            self._edge(stmt, body)
            # any body statement may raise into the handlers
            for inner in self._own_stmts(stmt.body):
                self._edge(inner, inner_raises)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            body = self._block(stmt.body, follow, breaks, continues, raises,
                               returns)
            self._edge(stmt, body)
        elif isinstance(stmt, ast.Return):
            self._edge(stmt, returns or [EXIT])
        elif isinstance(stmt, ast.Raise):
            self._edge(stmt, raises or [EXIT])
        elif isinstance(stmt, ast.Break):
            self._edge(stmt, breaks or [EXIT])
        elif isinstance(stmt, ast.Continue):
            self._edge(stmt, continues or [EXIT])
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
            self._edge(stmt, follow)  # a def is one opaque statement
        else:
            self._edge(stmt, follow)
        return [stmt]

    def _own_stmts(self, stmts: Sequence[ast.stmt]) -> List[ast.stmt]:
        """All statements nested under ``stmts`` (this function's only;
        nested defs are opaque)."""
        out: List[ast.stmt] = []
        stack = list(stmts)
        while stack:
            node = stack.pop()
            out.append(node)
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            for field in ("body", "orelse", "finalbody"):
                stack.extend(getattr(node, field, []) or [])
            for handler in getattr(node, "handlers", []) or []:
                stack.extend(handler.body)
        return out

    # -- queries -----------------------------------------------------------

    def stmt_of(self, node: ast.AST,
                parents: Dict[ast.AST, ast.AST]) -> Optional[ast.stmt]:
        """The CFG statement whose evaluation contains ``node``."""
        cur: Optional[ast.AST] = node
        while cur is not None:
            if id(cur) in self._stmt_set:
                return cur  # type: ignore[return-value]
            cur = parents.get(cur)
        return None

    def crosses_yield(self, src: ast.stmt, dst: ast.stmt,
                      yields: Set[ast.stmt],
                      start_crossed: bool = False) -> bool:
        """True when some path src -> ... -> dst crosses a statement in
        ``yields`` strictly between the two (or ``start_crossed``,
        i.e. the yield already happened inside ``src`` itself).

        Paths re-entering ``src`` are NOT followed: once the read/guard
        statement re-executes (a loop back edge), the value is fresh
        and the original stale-read window is gone."""
        seen: Set[Tuple[int, bool]] = set()
        frontier: List[Tuple[object, bool]] = [
            (n, start_crossed) for n in self.succ.get(src, [])
        ]
        while frontier:
            node, crossed = frontier.pop()
            if node is EXIT or node is src:
                continue
            if node is dst and crossed:
                return True
            key = (id(node), crossed)
            if key in seen:
                continue
            seen.add(key)
            nxt = crossed or (node in yields and node is not dst)
            for succ in self.succ.get(node, []):
                frontier.append((succ, nxt))
        return False

    def reaches_clean(self, src: ast.stmt, dst: ast.stmt,
                      yields: Set[ast.stmt]) -> bool:
        """True when some path src -> ... -> dst crosses NO task-switch
        point: a guard with a clean path to a write is a FRESH check --
        the re-check-after-await discipline that fixes check-then-act."""
        seen: Set[int] = set()
        frontier: List[object] = list(self.succ.get(src, []))
        while frontier:
            node = frontier.pop()
            if node is dst:
                return True
            if node is EXIT or id(node) in seen or node in yields:
                continue
            seen.add(id(node))
            frontier.extend(self.succ.get(node, []))
        return False

    def first_yield_before(self, src: ast.stmt, stops: Set[ast.stmt],
                           yields: Set[ast.stmt]) -> Optional[ast.stmt]:
        """First statement in ``yields`` reachable from ``src`` without
        passing through a statement in ``stops`` (release points); None
        when every path hits a stop (or EXIT) first."""
        seen: Set[int] = set()
        frontier: List[object] = list(self.succ.get(src, []))
        while frontier:
            node = frontier.pop()
            if node is EXIT or id(node) in seen:
                continue
            seen.add(id(node))
            if node in stops:
                continue
            if node in yields:
                return node  # type: ignore[return-value]
            frontier.extend(self.succ.get(node, []))
        return None


def build(fn: ast.AST) -> CFG:
    return CFG(fn)
