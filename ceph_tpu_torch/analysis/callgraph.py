"""Module-level call graph with per-function await summaries.

The single-function rules in ``rules_async.py`` cannot see the bug
class that cost PRs 2, 3 and 5 real rounds: shared-state invariants
broken by a task switch that happens inside a CALLEE.  This module
gives the flow rules the two facts they need:

* **yields** -- a function body contains an await that can actually
  suspend the task (park it on the event loop): an ``await`` of
  anything unresolved (``asyncio.sleep``, ``writer.drain()``, a bare
  future), an ``async for`` or ``async with``;
* **may-await** -- the transitive closure of *yields* over awaited
  calls to functions defined in the same module (plain names resolved
  lexically, ``self.``/``cls.`` methods resolved through the enclosing
  class, then module-wide when unambiguous).

The distinction matters in both directions.  ``await self._helper()``
where ``_helper`` transitively sleeps IS a task-switch point even
though the await's target looks local (the interprocedural positive);
``await self._pure()`` where ``_pure`` is an ``async def`` with no
awaits runs to completion synchronously and can NOT interleave with
another task (the precision negative -- flagging it would teach people
to ignore the rule).  Sync functions never have may-await: only an
``await`` expression yields, and sync bodies cannot contain one.

Like every cephlint component this is a pure AST consumer: nothing
under analysis is imported or executed.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple

from ceph_tpu_torch.analysis.core import FileContext, dotted_name

#: caps the fixpoint in pathological trees (cycles converge anyway;
#: this is a pure safety bound)
_MAX_ROUNDS = 50


class FunctionInfo:
    """Summary of one function/method definition."""

    __slots__ = ("qualname", "node", "is_async", "class_name",
                 "direct_yield", "awaited_callees", "may_await")

    def __init__(self, qualname: str, node: ast.AST, is_async: bool,
                 class_name: Optional[str]):
        self.qualname = qualname
        self.node = node
        self.is_async = is_async
        self.class_name = class_name
        #: body awaits something this module cannot prove non-yielding
        self.direct_yield = False
        #: qualnames of module-local functions this body awaits
        self.awaited_callees: Set[str] = set()
        #: fixpoint result: awaiting a call to this function may park
        #: the task on the event loop
        self.may_await = False


def _own_nodes(fn: ast.AST) -> Iterator[ast.AST]:
    """Walk ``fn``'s body without descending into nested function
    definitions (a nested def's awaits belong to ITS summary; a nested
    def's body does not run when the outer function does)."""
    stack: List[ast.AST] = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


class CallGraph:
    """Per-module call graph + may-await classification.

    Build one per :class:`FileContext` (rules share it through
    :func:`get`, which memoizes on the context instance).
    """

    def __init__(self, ctx: FileContext):
        self.ctx = ctx
        #: qualname -> FunctionInfo
        self.functions: Dict[str, FunctionInfo] = {}
        #: def node -> FunctionInfo (rule-side lookup)
        self.by_node: Dict[ast.AST, FunctionInfo] = {}
        #: lexical name tables: scope node -> {name: qualname}
        self._scopes: Dict[ast.AST, Dict[str, str]] = {}
        #: method name -> qualname when unambiguous module-wide,
        #: else None (two classes define it differently)
        self._methods: Dict[str, Optional[str]] = {}
        #: class name -> {method name -> qualname}
        self._class_methods: Dict[str, Dict[str, str]] = {}
        self._collect()
        self._summarize()
        self._fixpoint()

    # -- construction ------------------------------------------------------

    def _collect(self) -> None:
        parents = self.ctx.parent_map()
        for node in self.ctx.walk():
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            qual_parts = [node.name]
            class_name = None
            scope: ast.AST = self.ctx.tree
            cur: ast.AST = node
            while cur in parents:
                cur = parents[cur]
                if isinstance(cur, ast.ClassDef):
                    if class_name is None:
                        class_name = cur.name
                    qual_parts.append(cur.name)
                elif isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    if scope is self.ctx.tree:
                        scope = cur  # the def's NAME lives here
                    qual_parts.append(cur.name)
            qualname = ".".join(reversed(qual_parts))
            info = FunctionInfo(
                qualname, node,
                isinstance(node, ast.AsyncFunctionDef), class_name,
            )
            self.functions[qualname] = info
            self.by_node[node] = info
            self._scopes.setdefault(scope, {})[node.name] = qualname
            if class_name is not None:
                if node.name in self._methods and \
                        self._methods[node.name] != qualname:
                    self._methods[node.name] = None  # ambiguous
                else:
                    self._methods.setdefault(node.name, qualname)
                self._class_methods.setdefault(
                    class_name, {})[node.name] = qualname

    def _resolve_call(self, info: FunctionInfo,
                      call: ast.Call) -> Optional[str]:
        """Qualname of a called module-local function, or None when the
        target is unresolved (external module, computed, ambiguous)."""
        func = call.func
        if isinstance(func, ast.Name):
            # innermost lexical scope outward
            from ceph_tpu_torch.analysis.core import enclosing_functions

            for scope in reversed(
                    [self.ctx.tree] + enclosing_functions(self.ctx, call)):
                table = self._scopes.get(scope)
                if table and func.id in table:
                    return table[func.id]
            return None
        if isinstance(func, ast.Attribute) and \
                isinstance(func.value, ast.Name):
            base = func.value.id
            if base in ("self", "cls") and info.class_name is not None:
                own = self._class_methods.get(info.class_name, {})
                if func.attr in own:
                    return own[func.attr]
                return self._methods.get(func.attr)  # None when ambiguous
            if base in self._class_methods:  # ClassName.method(...)
                return self._class_methods[base].get(func.attr)
        return None

    def _summarize(self) -> None:
        for info in self.functions.values():
            if not info.is_async:
                continue  # a sync body cannot contain an await
            for node in _own_nodes(info.node):
                if isinstance(node, (ast.AsyncFor, ast.AsyncWith)):
                    # the iterator/CM protocol is outside this module:
                    # assume it suspends
                    info.direct_yield = True
                elif isinstance(node, ast.Await):
                    target = node.value
                    callee = self._resolve_call(info, target) \
                        if isinstance(target, ast.Call) else None
                    if callee is None:
                        info.direct_yield = True
                    else:
                        info.awaited_callees.add(callee)

    def _fixpoint(self) -> None:
        for info in self.functions.values():
            info.may_await = info.direct_yield
        for _ in range(_MAX_ROUNDS):
            changed = False
            for info in self.functions.values():
                if info.may_await:
                    continue
                for callee in info.awaited_callees:
                    target = self.functions.get(callee)
                    # awaiting a SYNC local function is a type error at
                    # runtime; treat it as a yield so the site surfaces
                    if target is None or not target.is_async \
                            or target.may_await:
                        info.may_await = True
                        changed = True
                        break
            if not changed:
                break

    # -- queries -----------------------------------------------------------

    def may_await_name(self, qualname: str) -> bool:
        info = self.functions.get(qualname)
        return bool(info and info.may_await)

    def awaiting_functions(self) -> List[str]:
        """Qualnames classified may-await (snapshot/test surface)."""
        return sorted(q for q, i in self.functions.items() if i.may_await)

    def expr_yield_node(self, info: FunctionInfo,
                        expr: ast.AST) -> Optional[ast.AST]:
        """First node inside ``expr`` that can suspend the enclosing
        task, or None.  Nested defs are opaque (their bodies don't run
        here)."""
        for node in self._walk_expr(expr):
            if isinstance(node, (ast.AsyncFor, ast.AsyncWith)):
                return node
            if isinstance(node, ast.Await):
                target = node.value
                if not isinstance(target, ast.Call):
                    return node
                callee = self._resolve_call(info, target)
                if callee is None:
                    return node
                target_info = self.functions.get(callee)
                if target_info is None or not target_info.is_async or \
                        target_info.may_await:
                    return node
        return None

    @staticmethod
    def _walk_expr(expr: ast.AST) -> Iterator[ast.AST]:
        stack = [expr]
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                continue
            yield node
            stack.extend(ast.iter_child_nodes(node))

    def stmt_yield_node(self, info: FunctionInfo,
                        stmt: ast.stmt) -> Optional[ast.AST]:
        """Like :meth:`expr_yield_node` but for a whole statement,
        without descending into a compound statement's nested block
        statements (those are separate CFG nodes)."""
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.stmt):
                continue
            node = self.expr_yield_node(info, child)
            if node is not None:
                return node
        if isinstance(stmt, (ast.AsyncFor, ast.AsyncWith)):
            return stmt
        return None

    def enclosing_function(self, node: ast.AST) -> Optional[FunctionInfo]:
        parents = self.ctx.parent_map()
        cur = node
        while cur in parents:
            cur = parents[cur]
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return self.by_node.get(cur)
        return None


#: FileContext -> CallGraph memo (contexts are per-file, per-scan)
_MEMO: Dict[int, Tuple[FileContext, CallGraph]] = {}


def get(ctx: FileContext) -> CallGraph:
    """The memoized call graph for ``ctx`` (several rules share one
    build per scanned file)."""
    entry = _MEMO.get(id(ctx))
    if entry is not None and entry[0] is ctx:
        return entry[1]
    graph = CallGraph(ctx)
    _MEMO.clear()  # files are scanned one at a time; keep one entry
    _MEMO[id(ctx)] = (ctx, graph)
    return graph
