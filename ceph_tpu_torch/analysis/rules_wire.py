"""Wire-schema symmetry rules.

The encoding framework (``utils/encoding.py``) gives every wire and
persist struct the same linear shape: an ordered sequence of codec
calls (``varint``/``string``/``blob``/``value``/...), optionally
version-guarded at the tail.  PRs 3 and 5 both evolved that shape under
compat constraints -- the v4 messenger's TRAILING piggyback-ack field
that v3 receivers never read, and the pre-reqid-frame rule where
``ECSubWrite.reqid`` decodes as ``dec.value() if dec.remaining() else
None`` -- and both rules lived only in review comments.  These rules
parse paired ``encode*``/``decode*`` bodies (and the
``message_encoder``/``decode_message`` dispatcher branches in
``msg/wire.py``, matched by their shared ``_MSG_*`` discriminator
constants) into linear field sequences and machine-check:

* ``wire-schema-symmetry`` -- encoder and decoder read/write the same
  ops in the same order (loops compared structurally; ``blob_ref``/
  ``blob_parts`` are wire-equal to ``blob``);
* ``wire-trailing-compat`` -- optional fields (``dec.remaining()`` /
  version-const guards) form a SUFFIX: appending is the only compatible
  evolution, so an unguarded field after a guarded one mis-parses every
  frame from a sender that omitted the optional field.  The guard
  itself is a contract older peers rely on, so it can be DECLARED: a
  ``# cephlint: wire-optional`` comment asserts the next decode read
  must stay guarded -- deleting the guard (the "simplifying" refactor
  that would silently break every pre-field sender) is then flagged
  even though the resulting code is internally consistent;
* ``wire-version-pairing`` -- every ``encode*`` has its ``decode*``
  twin in the same scope and no struct-version constant is referenced
  on only one side (the ENCODE_START/DECODE_START discipline; replaces
  the shallow ``ceph-encoding-version-pair`` rule).

Pure AST, like every cephlint rule: branches whose field content cannot
be linearized (a non-guard ``if`` writing fields) make the sequence
opaque from that point on rather than guessing.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterator, List, Optional, Set, Tuple

from ceph_tpu_torch.analysis.core import (SEV_ERROR, SEV_WARNING, FileContext,
                                    Finding, dotted_name, rule)

#: codec methods that produce/consume one wire field, normalized to the
#: wire-identical op (blob_ref and blob_parts emit a blob's bytes)
_FIELD_OPS = {
    "u8": "u8", "u32": "u32", "u64": "u64", "varint": "varint",
    "blob": "blob", "blob_ref": "blob", "blob_parts": "blob",
    "string": "string", "value": "value",
}
#: codec methods that are not fields (terminals, cursor queries)
_NON_FIELD_OPS = {"bytes", "parts", "nbytes", "remaining", "_take"}

_VERSION_CONST = re.compile(r"^_?[A-Z][A-Z0-9_]*VERSION[A-Z0-9_]*$|"
                            r"^_?[A-Z][A-Z0-9_]*_V$")

#: declared-optional marker: the next decode field read after this
#: comment must be remaining()/version guarded (older peers omit it)
_WIRE_OPTIONAL = re.compile(r"#\s*cephlint:\s*wire-optional\b")


class Item:
    """One linearized wire field / helper call."""

    __slots__ = ("kind", "name", "depth", "guarded", "node", "arg")

    def __init__(self, kind: str, name: str, depth: int, guarded: bool,
                 node: ast.AST, arg: Optional[str] = None):
        self.kind = kind      # "f" field | "c" helper call | "opaque"
        self.name = name
        self.depth = depth    # loop nesting depth
        self.guarded = guarded
        self.node = node
        self.arg = arg        # u8 discriminator constant, when a Name

    def describe(self) -> str:
        if self.kind == "c":
            return f"call {self.name}()"
        label = f"{self.name}"
        if self.depth:
            label += f" (in loop x{self.depth})"
        if self.guarded:
            label += " [guarded]"
        return label


def _norm_helper(name: str) -> str:
    return name.replace("encode", "", 1) if "encode" in name \
        else name.replace("decode", "", 1)


class _Extractor:
    """Linearize one function body's codec traffic on variable ``var``."""

    def __init__(self, var: str, kind: str):
        self.var = var
        #: "encode" | "decode": Encoder methods return self, so chained
        #: calls stay "the codec object"; Decoder methods return VALUES
        #: (``dec.value().items()`` is a dict method, not a codec op)
        self.kind = kind
        self.items: List[Item] = []
        self._depth = 0
        self._guard = 0

    # -- emit ---------------------------------------------------------------

    def _emit(self, kind: str, name: str, node: ast.AST,
              arg: Optional[str] = None) -> None:
        self.items.append(Item(kind, name, self._depth,
                               self._guard > 0, node, arg))

    # -- classification -----------------------------------------------------

    def _is_chain(self, expr: ast.AST) -> bool:
        """``expr`` evaluates to the codec object: the var itself or a
        chained codec call on it (Encoder methods return self)."""
        if isinstance(expr, ast.Name):
            return expr.id == self.var
        if self.kind == "encode" and isinstance(expr, ast.Call) and \
                isinstance(expr.func, ast.Attribute):
            return self._is_chain(expr.func.value)
        return False

    def _guard_test(self, test: ast.AST) -> bool:
        """A version/compat guard: consults ``remaining()`` on the codec
        var or references a struct-version constant/name."""
        for node in ast.walk(test):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "remaining" and \
                    self._is_chain(node.func.value):
                return True
            name = None
            if isinstance(node, ast.Name):
                name = node.id
            elif isinstance(node, ast.Attribute):
                name = node.attr
            if name and (_VERSION_CONST.match(name) or
                         "version" in name.lower() or
                         name.lower() in ("struct_v", "v")):
                return True
        return False

    # -- the walk (evaluation order) ----------------------------------------

    def stmts(self, body: List[ast.stmt]) -> None:
        for stmt in body:
            self.stmt(stmt)

    def stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return
        if isinstance(stmt, ast.If):
            if self._guard_test(stmt.test):
                self._guard += 1
                self.stmts(stmt.body)
                self._guard -= 1
                self.stmts(stmt.orelse)
            else:
                before = len(self.items)
                self.expr(stmt.test)
                self.stmts(stmt.body)
                self.stmts(stmt.orelse)
                if len(self.items) > before:
                    # field traffic under a non-guard branch cannot be
                    # linearized: make the tail opaque instead of lying
                    del self.items[before:]
                    self._emit("opaque", "branch", stmt)
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self.expr(stmt.iter)
            self._depth += 1
            self.stmts(stmt.body)
            self._depth -= 1
            self.stmts(stmt.orelse)
            return
        if isinstance(stmt, ast.While):
            before = len(self.items)
            self.expr(stmt.test)
            had_test = len(self.items) > before
            self._depth += 1
            self.stmts(stmt.body)
            self._depth -= 1
            if had_test:
                # a count read inside the while test re-runs per pass:
                # not a linear field sequence
                del self.items[before:]
                self._emit("opaque", "while", stmt)
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self.expr(item.context_expr)
            self.stmts(stmt.body)
            return
        if isinstance(stmt, ast.Try):
            self.stmts(stmt.body)
            for handler in stmt.handlers:
                self.stmts(handler.body)
            self.stmts(stmt.orelse)
            self.stmts(stmt.finalbody)
            return
        for child in ast.iter_child_nodes(stmt):
            if not isinstance(child, ast.stmt):
                self.expr(child)

    def expr(self, node: ast.AST) -> None:
        if node is None or isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            return
        if isinstance(node, ast.Call):
            self._call(node)
            return
        if isinstance(node, ast.IfExp):
            if self._guard_test(node.test):
                self._guard += 1
                self.expr(node.body)
                self._guard -= 1
                self.expr(node.orelse)
            else:
                before = len(self.items)
                self.expr(node.test)
                self.expr(node.body)
                self.expr(node.orelse)
                if len(self.items) > before:
                    del self.items[before:]
                    self._emit("opaque", "ifexp", node)
            return
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                             ast.DictComp)):
            for gen in node.generators:
                self.expr(gen.iter)
            self._depth += 1
            if isinstance(node, ast.DictComp):
                self.expr(node.key)
                self.expr(node.value)
            else:
                self.expr(node.elt)
            self._depth -= 1
            return
        for child in ast.iter_child_nodes(node):
            self.expr(child)

    def _call(self, call: ast.Call) -> None:
        func = call.func
        # codec op (possibly chained): inner chain evaluates first
        if isinstance(func, ast.Attribute) and self._is_chain(func.value):
            self.expr(func.value)
            for arg in call.args:
                self.expr(arg)
            for kw in call.keywords:
                self.expr(kw.value)
            attr = func.attr
            if attr in _FIELD_OPS:
                arg_name = None
                if attr == "u8" and call.args and \
                        isinstance(call.args[0], ast.Name):
                    arg_name = call.args[0].id
                self._emit("f", _FIELD_OPS[attr], call, arg_name)
            elif attr not in _NON_FIELD_OPS:
                self._emit("f", attr, call)  # future op: still compared
            return
        # helper call taking the codec var: one nested struct
        takes_var = any(isinstance(a, ast.Name) and a.id == self.var
                        for a in call.args)
        tail = dotted_name(func).rsplit(".", 1)[-1]
        if takes_var and ("encode" in tail or "decode" in tail):
            for arg in call.args:
                if not (isinstance(arg, ast.Name) and arg.id == self.var):
                    self.expr(arg)
            self._emit("c", _norm_helper(tail), call)
            return
        self.expr(func)
        for arg in call.args:
            self.expr(arg)
        for kw in call.keywords:
            self.expr(kw.value)


def _codec_var(fn: ast.AST, kind: str) -> Optional[str]:
    """The Encoder/Decoder variable a function works on: a parameter
    named ``enc*``/``dec*``, or a local assigned from ``Encoder()`` /
    ``Decoder(...)``."""
    prefix = "enc" if kind == "encode" else "dec"
    for arg in fn.args.args:
        if arg.arg == prefix or arg.arg.startswith(prefix):
            return arg.arg
    ctor = "Encoder" if kind == "encode" else "Decoder"
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                isinstance(node.value, ast.Call) and \
                dotted_name(node.value.func).rsplit(".", 1)[-1] == ctor:
            return node.targets[0].id
    return None


def _extract(fn: ast.AST, kind: str,
             body: Optional[List[ast.stmt]] = None,
             var: Optional[str] = None) -> Optional[List[Item]]:
    var = var or _codec_var(fn, kind)
    if var is None:
        return None
    ex = _Extractor(var, kind)
    ex.stmts(body if body is not None else fn.body)
    return ex.items


def _truncate_opaque(items: List[Item]) -> Tuple[List[Item], bool]:
    for i, item in enumerate(items):
        if item.kind == "opaque":
            return items[:i], True
    return items, False


def _scope_functions(ctx: FileContext):
    """(scope description, {name: def node}) for module + each class."""
    mod = {n.name: n for n in ctx.tree.body
           if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    yield "", mod
    for node in ctx.tree.body:
        if isinstance(node, ast.ClassDef):
            yield f"{node.name}.", {
                n.name: n for n in node.body
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def _pairs(fns: Dict[str, ast.AST]):
    for name, fn in fns.items():
        if name.startswith("encode") and \
                ("decode" + name[len("encode"):]) in fns:
            yield name, fn, fns["decode" + name[len("encode"):]]


def _referenced_version_consts(fn: ast.AST) -> Set[str]:
    out: Set[str] = set()
    for node in ast.walk(fn):
        name = None
        if isinstance(node, ast.Name):
            name = node.id
        elif isinstance(node, ast.Attribute):
            name = node.attr
        if name and _VERSION_CONST.match(name):
            out.add(name)
    return out


# -- dispatcher branches (msg/wire.py message_encoder/decode_message) ------

def _encoder_branches(ctx: FileContext) -> Dict[str, Tuple[List[Item],
                                                           ast.AST]]:
    """isinstance-dispatched encoder branches keyed by the ``_MSG_*``
    discriminator each branch stamps with ``enc.u8(CONST)``."""
    out: Dict[str, Tuple[List[Item], ast.AST]] = {}
    for node in ctx.walk():
        if not isinstance(node, ast.If):
            continue
        test = node.test
        if not (isinstance(test, ast.Call) and
                dotted_name(test.func) == "isinstance"):
            continue
        fn = _enclosing_fn(ctx, node)
        if fn is None:
            continue
        var = _codec_var(fn, "encode")
        if var is None:
            continue
        items = _extract(fn, "encode", body=node.body, var=var)
        if items and items[0].kind == "f" and items[0].name == "u8" and \
                items[0].arg:
            out[items[0].arg] = (items[1:], node)
    return out


def _decoder_branches(ctx: FileContext, keys: Set[str]
                      ) -> Dict[str, Tuple[List[Item], ast.AST]]:
    """``if kind == _MSG_X:`` decoder branches for known discriminators."""
    out: Dict[str, Tuple[List[Item], ast.AST]] = {}
    for node in ctx.walk():
        if not isinstance(node, ast.If):
            continue
        test = node.test
        if not (isinstance(test, ast.Compare) and len(test.ops) == 1 and
                isinstance(test.ops[0], ast.Eq) and
                isinstance(test.comparators[0], ast.Name) and
                test.comparators[0].id in keys):
            continue
        fn = _enclosing_fn(ctx, node)
        if fn is None:
            continue
        var = _codec_var(fn, "decode")
        if var is None:
            continue
        items = _extract(fn, "decode", body=node.body, var=var)
        if items is not None:
            out[test.comparators[0].id] = (items, node)
    return out


def _enclosing_fn(ctx: FileContext, node: ast.AST) -> Optional[ast.AST]:
    parents = ctx.parent_map()
    cur = node
    while cur in parents:
        cur = parents[cur]
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return cur
    return None


# -- rules -----------------------------------------------------------------

def _compare(ctx: FileContext, what: str, enc_items: List[Item],
             dec_items: List[Item],
             anchor: ast.AST) -> Iterator[Finding]:
    enc_seq, _enc_bail = _truncate_opaque(enc_items)
    dec_seq, _dec_bail = _truncate_opaque(dec_items)
    limit = min(len(enc_seq), len(dec_seq))
    for i in range(limit):
        a, b = enc_seq[i], dec_seq[i]
        if (a.kind, a.name if a.kind == "c" else a.name, a.depth) != \
                (b.kind, b.name if b.kind == "c" else b.name, b.depth):
            yield ctx.finding(
                "wire-schema-symmetry", b.node,
                f"{what}: field #{i + 1} diverges -- encoder writes "
                f"{a.describe()} (line {a.node.lineno}) but decoder "
                f"reads {b.describe()}; one side reordered or retyped "
                "a field and every frame now mis-parses from that "
                "offset",
            )
            return
    if _enc_bail or _dec_bail:
        return  # opaque tail: cannot judge the remainder
    if len(enc_seq) != len(dec_seq):
        if len(enc_seq) > len(dec_seq):
            extra, side, node = enc_seq[len(dec_seq)], "encoder", \
                enc_seq[len(dec_seq)].node
            other = "decoder never reads it"
        else:
            extra, side, node = dec_seq[len(enc_seq)], "decoder", \
                dec_seq[len(enc_seq)].node
            other = "encoder never writes it"
        yield ctx.finding(
            "wire-schema-symmetry", node,
            f"{what}: {side} has trailing {extra.describe()} that the "
            f"{other}; unguarded length skew breaks every peer on the "
            "other side of the wire",
        )


@rule(
    "wire-schema-symmetry", "ceph", SEV_ERROR,
    "paired encode*/decode* bodies (and the msg/wire.py dispatcher "
    "branches, matched by _MSG_* discriminator) linearized into field "
    "sequences must agree op-for-op, in order, loop structure included "
    "-- a reordered/retyped/one-sided field mis-parses every frame from "
    "that offset on",
)
def check_schema_symmetry(ctx: FileContext) -> Iterator[Finding]:
    if not ctx.imports_module("ceph_tpu_torch.utils.encoding"):
        return
    for scope, fns in _scope_functions(ctx):
        for name, enc_fn, dec_fn in _pairs(fns):
            enc_items = _extract(enc_fn, "encode")
            dec_items = _extract(dec_fn, "decode")
            if enc_items is None or dec_items is None:
                continue
            # decode-side guards are the compat tail: compare content
            yield from _compare(
                ctx, f"{scope}{name}/decode{name[len('encode'):]}",
                enc_items, dec_items, dec_fn)
    enc_branches = _encoder_branches(ctx)
    if enc_branches:
        dec_branches = _decoder_branches(ctx, set(enc_branches))
        for key in sorted(set(enc_branches) & set(dec_branches)):
            enc_items, _ = enc_branches[key]
            dec_items, dnode = dec_branches[key]
            yield from _compare(ctx, f"message kind {key}", enc_items,
                                dec_items, dnode)


@rule(
    "wire-trailing-compat", "ceph", SEV_ERROR,
    "optional wire fields (dec.remaining() / version-const guards) must "
    "form a SUFFIX of the struct: append-only evolution is the only "
    "compatible one (the v3->v4 messenger and pre-reqid ECSubWrite "
    "rules) -- an unguarded field after a guarded one mis-parses every "
    "frame from an older sender; a `# cephlint: wire-optional` comment "
    "declares the next decode read guard-mandatory, so removing the "
    "guard is flagged even when both sides still agree",
)
def check_trailing_compat(ctx: FileContext) -> Iterator[Finding]:
    if not ctx.imports_module("ceph_tpu_torch.utils.encoding"):
        return

    # honor only REAL comment tokens: a `wire-optional` spelling quoted
    # inside a docstring/fixture string is prose, not a declaration
    # (the round-12 section-marker gotcha, same fix)
    from ceph_tpu_torch.analysis.core import _comment_line_numbers

    comment_lines = _comment_line_numbers(ctx.lines)
    opt_lines = [i for i, line in enumerate(ctx.lines, start=1)
                 if _WIRE_OPTIONAL.search(line)
                 and (comment_lines is None or i in comment_lines)]

    def suffix_check(items: Optional[List[Item]], what: str
                     ) -> Iterator[Finding]:
        if not items:
            return
        seq, _ = _truncate_opaque(items)
        seen_guard: Optional[Item] = None
        for item in seq:
            if item.guarded:
                seen_guard = item
            elif seen_guard is not None:
                yield ctx.finding(
                    "wire-trailing-compat", item.node,
                    f"{what}: {item.describe()} is unguarded but "
                    f"follows optional {seen_guard.describe()} (line "
                    f"{seen_guard.node.lineno}); when the optional "
                    "field is absent this read consumes the wrong "
                    "bytes -- optional fields must be the trailing "
                    "suffix",
                )
                return

    def declared_check(items: Optional[List[Item]], span: ast.AST,
                       what: str) -> Iterator[Finding]:
        """`# cephlint: wire-optional` inside ``span``: the next decode
        field read must carry a remaining()/version guard.  The
        declaration survives the refactor that deletes the guard (the
        comment stays behind), which is exactly when it must fire."""
        if not items:
            return
        end = getattr(span, "end_lineno", None) or (1 << 30)
        for ln in opt_lines:
            if not span.lineno <= ln <= end:
                continue
            nxt = next((it for it in items
                        if it.kind == "f" and it.node.lineno >= ln), None)
            if nxt is not None and not nxt.guarded:
                yield ctx.finding(
                    "wire-trailing-compat", nxt.node,
                    f"{what}: {nxt.describe()} is declared wire-optional "
                    f"(line {ln}) but read unconditionally; peers that "
                    "predate the field send frames without it, so the "
                    "read must stay behind dec.remaining() or a "
                    "version guard",
                )

    for scope, fns in _scope_functions(ctx):
        for name, fn in fns.items():
            if name.startswith("encode"):
                yield from suffix_check(
                    _extract(fn, "encode"), f"{scope}{name}")
            elif name.startswith("decode"):
                yield from suffix_check(
                    _extract(fn, "decode"), f"{scope}{name}")
    if opt_lines:
        # declarations anchor to their INNERMOST enclosing function
        # (any name -- the tcp.py frame parser is not a decode* twin),
        # decoded with that function's own codec var
        fns_all = [n for n in ctx.walk()
                   if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        seen: Set[int] = set()
        for ln in opt_lines:
            best = None
            for fn in fns_all:
                fend = getattr(fn, "end_lineno", None) or fn.lineno
                if fn.lineno <= ln <= fend and \
                        (best is None or fn.lineno > best.lineno):
                    best = fn
            if best is None or id(best) in seen:
                continue
            seen.add(id(best))
            yield from declared_check(
                _extract(best, "decode"), best, best.name)
    enc_branches = _encoder_branches(ctx)
    if enc_branches:
        for key, (items, node) in sorted(_decoder_branches(
                ctx, set(enc_branches)).items()):
            yield from suffix_check(items, f"message kind {key}")
            yield from declared_check(items, node, f"message kind {key}")


@rule(
    "wire-version-pairing", "ceph", SEV_WARNING,
    "encode*/decode* twins in utils/encoding.py users: a one-sided "
    "serializer is a wire format with no reader, and a struct-version "
    "constant referenced only by the encoder cannot be gated on at the "
    "next format bump (ENCODE_START/DECODE_START discipline)",
)
def check_version_pairing(ctx: FileContext) -> Iterator[Finding]:
    if not ctx.imports_module("ceph_tpu_torch.utils.encoding"):
        return
    for scope, fns in _scope_functions(ctx):
        for name, fn in fns.items():
            if name.startswith("encode"):
                twin = "decode" + name[len("encode"):]
            elif name.startswith("decode"):
                twin = "encode" + name[len("decode"):]
            else:
                continue
            if twin not in fns:
                yield ctx.finding(
                    "wire-version-pairing", fn,
                    f"{scope}{name}() has no {twin}() counterpart; "
                    "serialized formats must keep both directions "
                    "together (src/include/encoding.h ENCODE/DECODE "
                    "discipline)",
                )
                continue
            if name.startswith("encode"):
                enc_v = _referenced_version_consts(fn)
                dec_v = _referenced_version_consts(fns[twin])
                for missing in sorted(enc_v - dec_v):
                    yield ctx.finding(
                        "wire-version-pairing", fn,
                        f"{scope}{name}() writes version constant "
                        f"{missing} but {twin}() never reads it: the "
                        "decoder cannot gate on struct version at the "
                        "next format bump",
                    )
