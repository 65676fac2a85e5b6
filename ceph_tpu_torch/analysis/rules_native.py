"""Native-extension boundary rules (the ``native`` pack).

The round-20 ``_wire_native`` C codec moved the hot wire loop across the
language boundary, out of reach of every Python-AST rule.  This pack
closes that gap using :mod:`ceph_tpu_torch.analysis.native_model`'s
lightweight C parser:

* ``native-refcount-leak-on-error-path`` -- a new (owned) reference is
  still live when the function takes an error exit (``return NULL`` /
  ``return -1`` / ``return PyErr_NoMemory()``) without a
  ``Py_DECREF``/``Py_XDECREF``/``Py_CLEAR``;
* ``native-gil-released-pyapi`` -- a Python C-API call between
  ``Py_BEGIN_ALLOW_THREADS`` and ``Py_END_ALLOW_THREADS`` (the GIL is
  not held there; touching the interpreter corrupts it);
* ``native-missing-fallback`` -- a typed encode path that rejects a
  value-model miss with anything other than ``FallbackError``.  The
  Python peer catches FallbackError and degrades that one message to
  the generic value codec; any other exception class tears the
  connection instead;
* ``native-schema-drift`` (headline) -- the C encoder/decoder dispatch
  branches, linearized to (op, loop-depth, guarded) field sequences by
  the native model, are diffed op-for-op against rules_wire.py's
  linearization of ``msg/wire.py`` -- the same machinery that powers
  ``wire-schema-symmetry``, now applied ACROSS the language boundary.
  Trailing-optional compat tails (``# cephlint: wire-optional`` on the
  Python side, ``d->pos < d->end`` guards on the C side) are part of
  the contract: dropping the guard on either side is drift even when
  each side stays internally consistent.

Like every cephlint rule these are pure source consumers: the C files
are tokenized and parsed, never compiled or imported, and ``msg/wire.py``
is read and ``ast``-parsed by path (importing it would initialize the
codec and potentially invoke make).
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, Iterator, List, Optional, Set, Tuple

from ceph_tpu_torch.analysis import native_model
from ceph_tpu_torch.analysis.core import (SEV_ERROR, _RULES, FileContext, Finding,
                                    rule)
from ceph_tpu_torch.analysis import rules_wire

_MSG_KEY_RE = re.compile(r"^_?MSG_[A-Z0-9_]+$")


class NativeFileContext:
    """FileContext counterpart for ``.c``/``.cpp`` sources: no AST, a
    :class:`~ceph_tpu_torch.analysis.native_model.NativeModel` instead."""

    is_native = True

    def __init__(self, path: str, source: str):
        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self.model = native_model.NativeModel(path, source)

    def finding(self, rule_obj_or_name, line: int, message: str,
                col: int = 0, severity: Optional[str] = None) -> Finding:
        name = getattr(rule_obj_or_name, "name", rule_obj_or_name)
        sev = severity or _RULES[name].severity
        return Finding(name, self.path, line, col, message, sev)


# ---------------------------------------------------------------------------
# refcount / GIL / fallback rules
# ---------------------------------------------------------------------------


@rule(
    "native-refcount-leak-on-error-path", "native", SEV_ERROR,
    "a new (owned) PyObject reference -- classified new-vs-borrowed from "
    "the CPython API table -- is still live at an error exit (return "
    "NULL / return -1 / return PyErr_NoMemory()) with no Py_DECREF/"
    "Py_XDECREF/Py_CLEAR on that path; under FallbackError-heavy "
    "workloads the error path IS the hot path, and each pass leaks the "
    "object",
)
def check_refcount_leak(ctx: NativeFileContext) -> Iterator[Finding]:
    for fn in ctx.model.functions.values():
        for leak in ctx.model.refcount_leaks(fn):
            yield ctx.finding(
                "native-refcount-leak-on-error-path", leak.exit_line,
                f"{fn.name}(): owned reference {leak.var!r} (created line "
                f"{leak.creation_line}) is still live at this error exit "
                "and never Py_DECREF'd on this path",
            )


@rule(
    "native-gil-released-pyapi", "native", SEV_ERROR,
    "a Python C-API call inside a Py_BEGIN/END_ALLOW_THREADS region: the "
    "GIL is released there, so touching the interpreter (allocation, "
    "refcounting, error state) is a data race on the interpreter state; "
    "only GIL-free calls (PyMem_Raw*, PyBytes_AS_STRING-style macro "
    "reads on already-held buffers) are allowed",
)
def check_gil_released_pyapi(ctx: NativeFileContext) -> Iterator[Finding]:
    for fn in ctx.model.functions.values():
        for v in native_model.gil_violations(fn):
            yield ctx.finding(
                "native-gil-released-pyapi", v.line,
                f"{fn.name}(): {v.call}() is called between "
                "Py_BEGIN_ALLOW_THREADS and Py_END_ALLOW_THREADS -- the "
                "GIL is not held here; re-acquire it (Py_BLOCK_THREADS) "
                "or move the call out of the region",
            )


_PYERR_SETTERS = ("PyErr_SetString", "PyErr_Format", "PyErr_SetObject")
_ENC_FN_RE = re.compile(r"^(?:emit_|enc_|encode_|py_encode_)")


@rule(
    "native-missing-fallback", "native", SEV_ERROR,
    "a typed encode path (emit_*/enc_*/encode_*) rejects a value-model "
    "miss with an exception class other than FallbackError; the Python "
    "caller catches FallbackError and degrades that one message to the "
    "generic value codec, while any other class propagates and tears "
    "the connection -- the per-message degradation contract the native "
    "codec was built around",
)
def check_missing_fallback(ctx: NativeFileContext) -> Iterator[Finding]:
    for fn in ctx.model.functions.values():
        if not _ENC_FN_RE.match(fn.name):
            continue
        toks = fn.body_tokens
        for i, t in enumerate(toks):
            if (
                t.kind == "id"
                and t.value in _PYERR_SETTERS
                and i + 1 < len(toks)
                and toks[i + 1].value == "("
            ):
                args = native_model._call_args(toks, i + 1)
                exc = native_model._single_id(args[0]) if args else None
                if exc is not None and exc != "FallbackError":
                    yield ctx.finding(
                        "native-missing-fallback", t.line,
                        f"{fn.name}(): raises {exc} on an encode miss; "
                        "typed encode paths must raise FallbackError so "
                        "the caller degrades this one message to the "
                        "value codec instead of tearing the connection",
                    )


# ---------------------------------------------------------------------------
# native-schema-drift: C field sequences vs msg/wire.py
# ---------------------------------------------------------------------------

#: flattened field: (op, loop-depth, guarded, source line)
_Flat = Tuple[str, int, bool, int]

_OPAQUE = "<opaque>"


def _wire_py_path() -> str:
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "msg", "wire.py",
    )


def _find_helper(ctx: FileContext, side: str, norm_name: str):
    word = "encode" if side == "encode" else "decode"
    for node in ctx.tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if word in node.name and \
                    rules_wire._norm_helper(node.name) == norm_name:
                return node
    return None


def _expand_py(items, ctx: FileContext, side: str, depth: int,
               guarded: bool, stack: Set[str]) -> List[_Flat]:
    """Fully flatten a rules_wire Item list: helper calls ("c" items)
    are spliced in-place with their loop-depth offset and guard OR'd."""
    out: List[_Flat] = []
    for it in items:
        line = getattr(it.node, "lineno", 0)
        g = guarded or it.guarded
        d = depth + it.depth
        if it.kind == "opaque":
            out.append((_OPAQUE, d, g, line))
        elif it.kind == "f":
            out.append((it.name, d, g, line))
        else:  # "c" helper
            helper = _find_helper(ctx, side, it.name)
            if helper is None or helper.name in stack:
                out.append((_OPAQUE, d, g, line))
                continue
            sub = rules_wire._extract(helper, side)
            if sub is None:
                out.append((_OPAQUE, d, g, line))
                continue
            stack.add(helper.name)
            out.extend(_expand_py(sub, ctx, side, d, g, stack))
            stack.discard(helper.name)
    return out


def _py_truncate(items: List[_Flat]) -> Tuple[List[_Flat], bool]:
    for i, it in enumerate(items):
        if it[0] == _OPAQUE:
            return items[:i], True
    return items, False


def _py_msg_keys(tree: ast.Module) -> Set[str]:
    keys: Set[str] = set()
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                _MSG_KEY_RE.match(node.targets[0].id):
            keys.add(node.targets[0].id)
    return keys


#: cached {(direction) -> {normalized MSG key -> (flat items, truncated,
#: branch line)}} from msg/wire.py, or None when wire.py is unavailable
_PY_SCHEMA: Optional[Dict[str, Dict[str, Tuple[List[_Flat], bool, int]]]]
_PY_SCHEMA = None
_PY_SCHEMA_LOADED = False


def _py_schema() -> Optional[Dict[str, Dict[str, Tuple[List[_Flat], bool,
                                                       int]]]]:
    global _PY_SCHEMA, _PY_SCHEMA_LOADED
    if _PY_SCHEMA_LOADED:
        return _PY_SCHEMA
    _PY_SCHEMA_LOADED = True
    path = _wire_py_path()
    try:
        with open(path, "r", encoding="utf-8") as f:
            source = f.read()
        tree = ast.parse(source)
    except (OSError, SyntaxError):
        return None
    ctx = FileContext("ceph_tpu_torch/msg/wire.py", source, tree)
    enc_branches = rules_wire._encoder_branches(ctx)
    dec_branches = rules_wire._decoder_branches(ctx, _py_msg_keys(tree))
    out: Dict[str, Dict[str, Tuple[List[_Flat], bool, int]]] = {
        "encode": {}, "decode": {},
    }
    for direction, branches in (("encode", enc_branches),
                                ("decode", dec_branches)):
        for key, (items, node) in branches.items():
            flat = _expand_py(items, ctx, direction, 0, False, set())
            seq, truncated = _py_truncate(flat)
            out[direction][key.lstrip("_")] = (
                seq, truncated, getattr(node, "lineno", 0))
    _PY_SCHEMA = out
    return out


def _diff_branch(ctx: NativeFileContext, direction: str, key: str,
                 branch: native_model.SchemaBranch,
                 py_seq: List[_Flat], py_truncated: bool,
                 py_line: int) -> Iterator[Finding]:
    """At most ONE finding per (kind, direction): the first divergence."""
    c_seq = list(branch.items)
    side_c = "writes" if direction == "encode" else "reads"
    limit = min(len(c_seq), len(py_seq))
    for i in range(limit):
        c, p = c_seq[i], py_seq[i]
        if (c.op, c.depth) != (p[0], p[1]):
            yield ctx.finding(
                "native-schema-drift", c.line,
                f"message kind {key} ({direction}): field #{i + 1} "
                f"diverges -- C {side_c} {_describe(c.op, c.depth)} but "
                f"msg/wire.py {side_c} {_describe(p[0], p[1])} (wire.py "
                f"line {p[3]}); one side of the language boundary "
                "reordered or retyped a field and every frame now "
                "mis-parses from that offset",
            )
            return
        if c.guarded != p[2]:
            if p[2]:  # py guarded, C not
                where, other = "msg/wire.py", "the C decoder reads it " \
                    "unconditionally"
            else:
                where, other = "the C decoder", "msg/wire.py reads it " \
                    "unconditionally"
            yield ctx.finding(
                "native-schema-drift", c.line,
                f"message kind {key} ({direction}): field #{i + 1} "
                f"({c.op}) is optional-guarded in {where} (wire.py line "
                f"{p[3]}) but {other}; the trailing-optional compat tail "
                "(# cephlint: wire-optional) is a cross-language "
                "contract -- peers that omit the field break the "
                "unguarded side",
            )
            return
    if branch.truncated or py_truncated:
        return
    if len(c_seq) != len(py_seq):
        if len(c_seq) > len(py_seq):
            extra = c_seq[len(py_seq)]
            yield ctx.finding(
                "native-schema-drift", extra.line,
                f"message kind {key} ({direction}): C has trailing "
                f"{_describe(extra.op, extra.depth)} that msg/wire.py "
                f"(line {py_line}) never {side_c}; unguarded length skew "
                "across the language boundary breaks every mixed-codec "
                "peer pair",
            )
        else:
            extra = py_seq[len(c_seq)]
            yield ctx.finding(
                "native-schema-drift", branch.line,
                f"message kind {key} ({direction}): msg/wire.py has "
                f"trailing {_describe(extra[0], extra[1])} (wire.py line "
                f"{extra[3]}) that the C side never {side_c}; unguarded "
                "length skew across the language boundary breaks every "
                "mixed-codec peer pair",
            )


def _describe(op: str, depth: int) -> str:
    return f"{op} (in loop x{depth})" if depth else op


@rule(
    "native-schema-drift", "native", SEV_ERROR,
    "the C codec's typed encode/decode dispatch branches, linearized to "
    "(op, loop-depth, guarded) field sequences, must agree op-for-op "
    "with rules_wire.py's linearization of msg/wire.py -- including the "
    "trailing-optional compat-tail guards (# cephlint: wire-optional / "
    "d->pos < d->end); a field reordered, retyped, added one-sided or "
    "de-guarded across the language boundary is a lint finding here, "
    "not a corpus-lottery runtime bug (FallbackError only catches "
    "per-value misses, never per-schema drift)",
)
def check_schema_drift(ctx: NativeFileContext) -> Iterator[Finding]:
    c_enc = native_model.encoder_branches(ctx.model)
    c_dec = native_model.decoder_branches(ctx.model)
    if not c_enc and not c_dec:
        return
    schema = _py_schema()
    if schema is None:
        return
    for direction, branches in (("encode", c_enc), ("decode", c_dec)):
        py_side = schema[direction]
        for key in sorted(branches):
            norm = key.lstrip("_")
            if norm not in py_side:
                continue  # kind absent on the Python side: degradation
                # via the value codec, not drift
            py_seq, py_trunc, py_line = py_side[norm]
            yield from _diff_branch(ctx, direction, norm, branches[key],
                                    py_seq, py_trunc, py_line)
