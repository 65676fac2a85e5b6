"""cephlint core: findings, the rule registry, and AST helpers.

A *rule* is a function ``check(ctx: FileContext) -> Iterable[Finding]``
registered with the :func:`rule` decorator; the runner calls every
registered rule on every scanned file.  Rules are pure AST/source
consumers -- they never import or execute the code under analysis, so
the analyzer is safe to run over broken or half-written trees (parse
failures surface as a ``parse-error`` finding instead of crashing the
scan).  Port of ``ceph_tpu/analysis/core.py``: the registry also loads
the ``torch`` pack in place of the ``jax`` pack, and the JAX-only
``is_jitted`` helper is gone (PyTorch has no jitted-callee idiom the
residency lattice could read).
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Callable, Dict, Iterable, List, Optional, Tuple

SEV_ERROR = "error"
SEV_WARNING = "warning"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One diagnostic at a source location."""

    rule: str
    path: str          # repo-relative posix path
    line: int          # 1-based
    col: int           # 0-based (ast convention)
    message: str
    severity: str = SEV_WARNING

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def format(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: "
                f"{self.severity}: [{self.rule}] {self.message}")


@dataclasses.dataclass
class Rule:
    name: str
    pack: str          # "async" | "torch" | "ceph" | "native"
    severity: str
    description: str
    check: Callable[["FileContext"], Iterable[Finding]]


#: name -> Rule; populated by the @rule decorator at import time
_RULES: Dict[str, Rule] = {}


def rule(name: str, pack: str, severity: str, description: str):
    """Register a rule-check function under ``name``."""

    def deco(fn):
        if name in _RULES:
            raise ValueError(f"duplicate rule {name!r}")
        _RULES[name] = Rule(name, pack, severity, description, fn)
        return fn

    return deco


def all_rules() -> Dict[str, Rule]:
    # import the packs lazily so `import ceph_tpu_torch.analysis.core` alone
    # doesn't force them, but any registry consumer sees every rule
    from ceph_tpu_torch.analysis import rules_async  # noqa: F401
    from ceph_tpu_torch.analysis import rules_config  # noqa: F401
    from ceph_tpu_torch.analysis import rules_interleave  # noqa: F401
    from ceph_tpu_torch.analysis import rules_native  # noqa: F401
    from ceph_tpu_torch.analysis import rules_osdmap  # noqa: F401
    from ceph_tpu_torch.analysis import rules_perf  # noqa: F401
    from ceph_tpu_torch.analysis import rules_profile  # noqa: F401
    from ceph_tpu_torch.analysis import rules_residency  # noqa: F401
    from ceph_tpu_torch.analysis import rules_torch  # noqa: F401
    from ceph_tpu_torch.analysis import rules_trace  # noqa: F401
    from ceph_tpu_torch.analysis import rules_wire  # noqa: F401

    return dict(_RULES)


class FileContext:
    """Everything a rule may look at for one file."""

    def __init__(self, path: str, source: str, tree: ast.Module):
        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree
        self._parents: Optional[Dict[ast.AST, ast.AST]] = None
        self._imported: Optional[frozenset] = None
        self._nodes: Optional[List[ast.AST]] = None

    # -- shared helpers ----------------------------------------------------

    def parent_map(self) -> Dict[ast.AST, ast.AST]:
        if self._parents is None:
            self._parents = {}
            for node in self.walk():
                for child in ast.iter_child_nodes(node):
                    self._parents[child] = node
        return self._parents

    def walk(self) -> List[ast.AST]:
        """``list(ast.walk(self.tree))``, built once per file: every rule
        walks the whole module, so the walk is shared."""
        if self._nodes is None:
            self._nodes = list(ast.walk(self.tree))
        return self._nodes

    def finding(self, rule_obj_or_name, node: ast.AST, message: str,
                severity: Optional[str] = None) -> Finding:
        name = getattr(rule_obj_or_name, "name", rule_obj_or_name)
        sev = severity or _RULES[name].severity
        return Finding(name, self.path, getattr(node, "lineno", 1),
                       getattr(node, "col_offset", 0), message, sev)

    def imports_module(self, *names: str) -> bool:
        """True if the file imports any of ``names`` (top-level module
        match: ``torch`` matches ``import torch.nn`` and
        ``from torch import ...``)."""
        if self._imported is None:
            # one walk per file, however many rules ask
            imported = set()
            for node in self.walk():
                if isinstance(node, ast.Import):
                    for alias in node.names:
                        imported.add(alias.name)
                        imported.add(alias.name.split(".")[0])
                elif isinstance(node, ast.ImportFrom) and node.module:
                    imported.add(node.module)
                    imported.add(node.module.split(".")[0])
            self._imported = frozenset(imported)
        return any(n in self._imported for n in names)


def dotted_name(node: ast.AST) -> str:
    """Best-effort dotted name of an expression: ``asyncio.create_task``,
    ``loop.create_task``, ``().create_task`` (call results collapse to
    ``()``).  Used to match call targets without type inference."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return f"{dotted_name(node.value)}.{node.attr}"
    if isinstance(node, ast.Call):
        return "()"
    return "?"


def call_name(call: ast.Call) -> str:
    return dotted_name(call.func)


def call_attr(call: ast.Call) -> str:
    """Last attribute segment of the call target (``create_task`` for
    any of the spellings)."""
    return call_name(call).rsplit(".", 1)[-1]


def enclosing_functions(ctx: FileContext, node: ast.AST) -> List[ast.AST]:
    """Function-def chain from outermost to innermost around ``node``."""
    chain: List[ast.AST] = []
    parents = ctx.parent_map()
    cur = node
    while cur in parents:
        cur = parents[cur]
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            chain.append(cur)
    chain.reverse()
    return chain


def in_async_context(ctx: FileContext, node: ast.AST) -> bool:
    """True when ``node`` executes on the event loop: its *innermost*
    enclosing function is ``async def`` (a nested sync def runs wherever
    it is called from -- the call site gets flagged, not the body)."""
    chain = enclosing_functions(ctx, node)
    return bool(chain) and isinstance(chain[-1], ast.AsyncFunctionDef)


def decorator_names(fn: ast.AST) -> List[str]:
    out = []
    for dec in getattr(fn, "decorator_list", []):
        if isinstance(dec, ast.Call):
            out.append(dotted_name(dec.func))
            out.extend(dotted_name(a) for a in dec.args)
        else:
            out.append(dotted_name(dec))
    return out


import re as _re

#: declared yield-free regions, marked by comment pairs of the form
#: ``cephlint: atomic-section <name>`` ... ``cephlint:
#: end-atomic-section`` (each after a ``#``).  The annotation is a
#: contract, enforced twice: statically (rules_interleave flags any
#: task-switch point between the markers) and at runtime
#: (analysis/runtime.py asserts no task ever suspends inside one).
_ATOMIC_BEGIN = _re.compile(
    r"#\s*cephlint:\s*atomic-section\s+([A-Za-z0-9_.\-]+)")
_ATOMIC_END = _re.compile(r"#\s*cephlint:\s*end-atomic-section\b")

#: declared device-resident regions: ``cephlint: device-resident-section
#: <name>`` ... ``cephlint: end-device-resident-section``.  Inside the
#: markers no value may leave the device (no D2H sink -- np.asarray,
#: .cpu(), .numpy(), .item(), .tolist(), float()/int(), iteration,
#: device_get).  Enforced twice: statically (rules_residency walks the
#: residency lattice through the region, helpers included) and at
#: runtime (analysis/residency.py makes every counted D2H seam inside the
#: paired ``resident_section(name)`` scope a violation).
_RESIDENT_BEGIN = _re.compile(
    r"#\s*cephlint:\s*device-resident-section\s+([A-Za-z0-9_.\-]+)")
_RESIDENT_END = _re.compile(r"#\s*cephlint:\s*end-device-resident-section\b")

#: declared wire hot sections: ``cephlint: wire-hot-section <name>`` ...
#: ``cephlint: end-wire-hot-section``.  Inside the markers the
#: ``wire-hot-path-alloc`` rule (rules_profile) flags per-frame bytes
#: concatenation -- the allocation class the zero-copy part-list
#: discipline (docs/messenger.md) exists to avoid.  Advisory: the
#: declared regions are the per-frame seams the wire-tax profiler
#: instruments, where one stray ``a + b`` on bytes costs a copy per
#: frame.
_WIREHOT_BEGIN = _re.compile(
    r"#\s*cephlint:\s*wire-hot-section\s+([A-Za-z0-9_.\-]+)")
_WIREHOT_END = _re.compile(r"#\s*cephlint:\s*end-wire-hot-section\b")


@dataclasses.dataclass(frozen=True)
class AtomicSection:
    """One declared yield-free region: the markers sit on ``start`` and
    ``end``; the protected statements are the lines strictly between."""

    name: str
    start: int  # 1-based line of the begin marker
    end: int    # 1-based line of the end marker


def _comment_line_numbers(lines) -> "Optional[set]":
    """1-based line numbers that carry a real ``#`` comment token, so
    marker regexes don't fire on marker text quoted inside string
    literals (e.g. a test embedding a marked source as a fixture).
    Returns None when the file doesn't tokenize -- callers fall back to
    treating every line as eligible."""
    import io
    import tokenize
    src = "\n".join(lines) + "\n"
    out = set()
    try:
        for tok in tokenize.generate_tokens(io.StringIO(src).readline):
            if tok.type == tokenize.COMMENT:
                out.add(tok.start[0])
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return None
    return out


def _parse_marked_sections(lines, begin_re, end_re, what: str,
                           end_spelling: str):
    """Shared marker-pair parser: (sections, problems) where problems
    are (line, message) pairs -- an end without a begin, a begin without
    an end, a begin nested inside an open section."""
    sections: List[AtomicSection] = []
    problems: List[tuple] = []
    open_name: Optional[str] = None
    open_line = 0
    if not any(begin_re.search(ln) or end_re.search(ln) for ln in lines):
        return sections, problems
    comment_lines = _comment_line_numbers(lines)
    for i, line in enumerate(lines, start=1):
        if comment_lines is not None and i not in comment_lines:
            continue
        m = begin_re.search(line)
        if m:
            if open_name is not None:
                problems.append((
                    i, f"{what} {m.group(1)!r} opens inside "
                       f"still-open section {open_name!r} (line "
                       f"{open_line}); sections cannot nest"))
            open_name, open_line = m.group(1), i
            continue
        if end_re.search(line):
            if open_name is None:
                problems.append((
                    i, f"{end_spelling} without a matching "
                       f"{what} begin"))
            else:
                sections.append(AtomicSection(open_name, open_line, i))
                open_name = None
    if open_name is not None:
        problems.append((
            open_line,
            f"{what} {open_name!r} is never closed "
            f"(missing {end_spelling})"))
    return sections, problems


def parse_atomic_sections(lines) -> "Tuple[List[AtomicSection], List[Tuple[int, str]]]":  # noqa: E501
    """(sections, problems) from a file's source lines."""
    return _parse_marked_sections(lines, _ATOMIC_BEGIN, _ATOMIC_END,
                                  "atomic-section", "end-atomic-section")


def parse_resident_sections(lines) -> "Tuple[List[AtomicSection], List[Tuple[int, str]]]":  # noqa: E501
    """(sections, problems) for declared device-resident regions."""
    return _parse_marked_sections(
        lines, _RESIDENT_BEGIN, _RESIDENT_END,
        "device-resident-section", "end-device-resident-section")


def parse_wire_hot_sections(lines) -> "Tuple[List[AtomicSection], List[Tuple[int, str]]]":  # noqa: E501
    """(sections, problems) for declared wire hot sections."""
    return _parse_marked_sections(
        lines, _WIREHOT_BEGIN, _WIREHOT_END,
        "wire-hot-section", "end-wire-hot-section")


def module_str_constants(tree: ast.Module) -> Dict[str, str]:
    """Module-level ``NAME = "literal"`` assignments (lets rules resolve
    e.g. ``os.environ.get(STATE_ENV)`` through the constant)."""
    out: Dict[str, str] = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                isinstance(node.value, ast.Constant) and \
                isinstance(node.value.value, str):
            out[node.targets[0].id] = node.value.value
    return out
