"""Wire-tax profiler hygiene rules.

``profile-stage-unpaired``: a ledger stage opened with the paired-call
form (``profiling.stage_enter(marker)``) on a CFG path that can exit
the function without the matching ``stage_exit``.  A stage left open
keeps absorbing time (the exclusive-accounting stack never pops), so
every later cost center under-reports and the decomposition's coverage
gate reads garbage -- the profiler twin of ``trace-span-unfinished``,
built on the same CFG machinery.  The ``with stage(name):`` form closes
itself and is always clean; the paired form exists only for seams where
the result of the staged call must be awaited OUTSIDE the stage (the
coalescer dispatch), and there every enter must reach an exit on every
path -- try/finally is the idiom.

``wire-hot-path-alloc``: per-frame ``bytes`` concatenation inside a
declared ``# cephlint: wire-hot-section`` region.  The zero-copy wire
discipline (docs/messenger.md) moves payloads as part LISTS precisely
so no per-frame copy happens; one stray ``head + body`` on bytes inside
the per-frame seams re-introduces a copy per frame -- the allocation
class the wire-tax profiler's off-mode pin also guards.  Advisory
(warning): list concatenation, ``b"".join`` and out-of-section code are
clean; the bytes-ness of a name is inferred conservatively from its
assignments inside the same function, so only provable concatenations
fire.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Set, Tuple

from ceph_tpu_torch.analysis import cfg as cfg_mod
from ceph_tpu_torch.analysis.core import (SEV_WARNING, FileContext, Finding,
                                    call_attr, parse_wire_hot_sections,
                                    rule)
from ceph_tpu_torch.analysis.rules_trace import _header_exprs, _leaks

_ENTER = "stage_enter"
_EXIT = "stage_exit"


def _stage_stmts(cfg: "cfg_mod.CFG", attr: str) -> List[ast.stmt]:
    """CFG statements whose own expressions call ``*.{attr}(...)``."""
    out: List[ast.stmt] = []
    for stmt in cfg.stmts:
        for node in _header_exprs(stmt):
            if isinstance(node, ast.Call) and call_attr(node) == attr:
                out.append(stmt)
                break
    return out


@rule(
    "profile-stage-unpaired", "ceph", SEV_WARNING,
    "a profiling stage opened with stage_enter() has a control-flow "
    "path that exits the function without stage_exit(): the stage "
    "keeps absorbing time, every later cost center under-reports, and "
    "the decomposition's coverage gate reads garbage -- close it in a "
    "try/finally, or use the `with stage(name):` form when no await "
    "splits the work",
)
def check_stage_unpaired(ctx: FileContext) -> Iterator[Finding]:
    if _ENTER not in ctx.source:
        return  # no stage opened anywhere in the file
    for fn in ctx.walk():
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        has_enter = any(
            isinstance(node, ast.Call) and call_attr(node) == _ENTER
            for node in ast.walk(fn)
        )
        if not has_enter:
            continue
        graph = cfg_mod.build(fn)
        enters = _stage_stmts(graph, _ENTER)
        if not enters:
            continue
        closers: Set[ast.stmt] = set(_stage_stmts(graph, _EXIT))
        for stmt in enters:
            if _leaks(graph, stmt, closers - {stmt}):
                yield ctx.finding(
                    "profile-stage-unpaired", stmt,
                    "stage_enter() can reach function exit without "
                    "stage_exit(): the open stage swallows every later "
                    "cost center's time; pair it in a try/finally or "
                    "use `with stage(name):`",
                )


# -- wire-hot-path-alloc -----------------------------------------------------

#: call attrs whose result is (conservatively) bytes
_BYTES_CALL_ATTRS = {"tobytes", "to_bytes"}


def _is_bytes_expr(node: ast.AST, known: Set[str]) -> bool:
    """Provably-bytes expression: a bytes literal, bytes()/…tobytes()
    call, ``b"".join(...)``, or a name whose assignments were bytes."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, bytes)
    if isinstance(node, ast.Name):
        return node.id in known
    if isinstance(node, ast.Call):
        func = node.func
        if isinstance(func, ast.Name) and func.id == "bytes":
            return True
        if isinstance(func, ast.Attribute):
            if func.attr in _BYTES_CALL_ATTRS:
                return True
            if func.attr == "join" and _is_bytes_expr(func.value, known):
                return True
        return False
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        return _is_bytes_expr(node.left, known) or \
            _is_bytes_expr(node.right, known)
    if isinstance(node, ast.Subscript):
        # a slice of a bytes value is bytes (buf[pos:])
        return isinstance(node.slice, ast.Slice) and \
            _is_bytes_expr(node.value, known)
    return False


def _bytes_names(fn: ast.AST) -> Set[str]:
    """Names provably bound to bytes somewhere in ``fn`` (two passes so
    ``a = b"" ; b = a + x`` converges)."""
    known: Set[str] = set()
    for _ in range(2):
        before = len(known)
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and _is_bytes_expr(node.value, known):
                known.add(node.targets[0].id)
            elif isinstance(node, ast.AugAssign) and \
                    isinstance(node.op, ast.Add) and \
                    isinstance(node.target, ast.Name) and \
                    _is_bytes_expr(node.value, known):
                known.add(node.target.id)
        if len(known) == before:
            break
    return known


def _section_ranges(ctx: FileContext) -> Tuple[List, List]:
    return parse_wire_hot_sections(ctx.lines)


@rule(
    "wire-hot-path-alloc", "ceph", SEV_WARNING,
    "bytes concatenation inside a declared `cephlint: "
    "wire-hot-section` region: the zero-copy wire path moves payloads "
    "as part lists precisely so no per-frame copy happens -- a stray "
    "`a + b` on bytes here costs an allocation and a memcpy per "
    "frame.  Build a part list (Encoder.parts / blob_parts) or hoist "
    "the join out of the per-frame seam; advisory, so a justified "
    "inline disable is acceptable for provably-amortized compaction",
)
def check_wire_hot_alloc(ctx: FileContext) -> Iterator[Finding]:
    sections, problems = _section_ranges(ctx)
    for line, message in problems:
        yield Finding("wire-hot-path-alloc", ctx.path, line, 0,
                      message, SEV_WARNING)
    if not sections:
        return
    spans = [(s.start, s.end, s.name) for s in sections]

    def _section_of(lineno: int):
        for start, end, name in spans:
            if start < lineno < end:
                return name
        return None

    #: per-function bytes-name cache (names are function-scoped)
    fn_names: Dict[ast.AST, Set[str]] = {}
    parents = ctx.parent_map()

    def _known_for(node: ast.AST) -> Set[str]:
        cur = node
        while cur in parents:
            cur = parents[cur]
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                names = fn_names.get(cur)
                if names is None:
                    names = fn_names[cur] = _bytes_names(cur)
                return names
        names = fn_names.get(ctx.tree)
        if names is None:
            names = fn_names[ctx.tree] = _bytes_names(ctx.tree)
        return names

    seen: Set[int] = set()
    for node in ctx.walk():
        lineno = getattr(node, "lineno", None)
        if lineno is None:
            continue
        name = _section_of(lineno)
        if name is None:
            continue
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
            known = _known_for(node)
            if _is_bytes_expr(node.left, known) or \
                    _is_bytes_expr(node.right, known):
                if id(node) in seen:
                    continue
                # a nested Add chain (a + b + c) reports once, at the
                # outermost BinOp the walk reaches first
                for sub in ast.walk(node):
                    if sub is not node:
                        seen.add(id(sub))
                yield ctx.finding(
                    "wire-hot-path-alloc", node,
                    f"bytes concatenation inside wire hot section "
                    f"{name!r}: one allocation + memcpy per frame -- "
                    "carry a part list instead of joining",
                )
        elif isinstance(node, ast.AugAssign) and \
                isinstance(node.op, ast.Add):
            known = _known_for(node)
            if (isinstance(node.target, ast.Name)
                    and node.target.id in known) or \
                    _is_bytes_expr(node.value, known):
                yield ctx.finding(
                    "wire-hot-path-alloc", node,
                    f"bytes += inside wire hot section {name!r}: "
                    "quadratic per-frame reallocation -- append to a "
                    "part list and join once outside the seam",
                )
