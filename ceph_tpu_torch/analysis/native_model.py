"""Lightweight C/C++ model for the native-extension lint pack.

cephlint's Python packs lean on ``ast``; there is no such luxury for the
``.c``/``.cpp`` sources under ``ceph_tpu_torch/native/``.  This module builds
just enough of a model to support the four ``native-*`` rules:

* a tokenizer that strips comments and preprocessor lines (macro bodies
  are deliberately invisible -- a macro call is just an unknown
  function call, which the refcount analysis treats conservatively),
* top-level function extraction (name, parameters, return type),
* a statement-level parser (blocks, if/else, loops, switch/case,
  return/goto/label/break/continue, ``Py_BEGIN/END_ALLOW_THREADS``),
* a refcount dataflow over an explicit CFG, classifying CPython API
  calls as new-vs-borrowed from a table and reporting owned references
  still live at error exits,
* GIL-region facts (which Python C-API calls happen between
  ``Py_BEGIN_ALLOW_THREADS`` and ``Py_END_ALLOW_THREADS``),
* a wire-schema flattener that linearizes each typed ``encode_*`` /
  ``decode_*`` body into the same (op, depth, guarded) item stream
  rules_wire.py derives from ``msg/wire.py`` -- the raw material for
  ``native-schema-drift``.

Everything here must fail SOFT: a function the parser cannot digest
contributes no facts (and no findings) rather than crashing the scan.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

# ---------------------------------------------------------------------------
# tokenizer
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Tok:
    kind: str  # "id" | "num" | "str" | "char" | "punct"
    value: str
    line: int


_TWO_CHAR = {
    "->", "++", "--", "==", "!=", "<=", ">=", "&&", "||", "<<", ">>",
    "+=", "-=", "*=", "/=", "%=", "|=", "&=", "^=", "::",
}

_ID_START = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ_")
_ID_CONT = _ID_START | set("0123456789")
_DIGITS = set("0123456789")
_NUM_CONT = _DIGITS | set("abcdefABCDEFxXuUlL.")


def tokenize(source: str) -> List[Tok]:
    """Tokenize C source; comments and preprocessor lines are dropped."""
    toks: List[Tok] = []
    i, n = 0, len(source)
    line = 1
    bol = True  # at beginning of line (modulo whitespace) -> '#' is preproc
    while i < n:
        c = source[i]
        if c == "\n":
            line += 1
            i += 1
            bol = True
            continue
        if c in " \t\r\f\v":
            i += 1
            continue
        if c == "/" and i + 1 < n and source[i + 1] == "/":
            while i < n and source[i] != "\n":
                i += 1
            continue
        if c == "/" and i + 1 < n and source[i + 1] == "*":
            i += 2
            while i + 1 < n and not (source[i] == "*" and source[i + 1] == "/"):
                if source[i] == "\n":
                    line += 1
                i += 1
            i = min(i + 2, n)
            continue
        if c == "#" and bol:
            # preprocessor directive: skip to end of line, honouring
            # backslash continuations (this hides #define bodies)
            while i < n:
                if source[i] == "\\" and i + 1 < n and source[i + 1] == "\n":
                    line += 1
                    i += 2
                    continue
                if source[i] == "\n":
                    break
                i += 1
            continue
        if c == '"':
            j = i + 1
            while j < n and source[j] != '"':
                if source[j] == "\\":
                    j += 1
                j += 1
            toks.append(Tok("str", source[i + 1 : j], line))
            i = j + 1
            bol = False
            continue
        if c == "'":
            j = i + 1
            while j < n and source[j] != "'":
                if source[j] == "\\":
                    j += 1
                j += 1
            toks.append(Tok("char", source[i + 1 : j], line))
            i = j + 1
            bol = False
            continue
        if c in _ID_START:
            j = i + 1
            while j < n and source[j] in _ID_CONT:
                j += 1
            toks.append(Tok("id", source[i:j], line))
            i = j
            bol = False
            continue
        if c in _DIGITS:
            j = i + 1
            while j < n and source[j] in _NUM_CONT:
                j += 1
            toks.append(Tok("num", source[i:j], line))
            i = j
            bol = False
            continue
        two = source[i : i + 2]
        if two in _TWO_CHAR:
            toks.append(Tok("punct", two, line))
            i += 2
            bol = False
            continue
        toks.append(Tok("punct", c, line))
        i += 1
        bol = False
    return toks


# ---------------------------------------------------------------------------
# statements
# ---------------------------------------------------------------------------


@dataclass
class Stmt:
    kind: str  # Block If Loop Switch Return Goto Label Break Continue Gil Expr
    line: int
    tokens: List[Tok] = field(default_factory=list)  # Expr/Return/Goto/Label
    cond: List[Tok] = field(default_factory=list)  # If/Loop/Switch condition
    body: List["Stmt"] = field(default_factory=list)  # Block/If-then/Loop
    orelse: List["Stmt"] = field(default_factory=list)  # If-else
    cases: List[Tuple[List[List[Tok]], List["Stmt"]]] = field(
        default_factory=list
    )  # Switch: [(case-label-token-runs, stmts)]
    init: List[Tok] = field(default_factory=list)  # for-init
    step: List[Tok] = field(default_factory=list)  # for-step
    marker: str = ""  # Gil: "begin"/"end"; Label/Goto: name; Return macro name


@dataclass
class CFunc:
    name: str
    line: int
    params: List[str]
    pyobject_params: Set[str]
    ret_tokens: List[Tok]
    body: List[Stmt]
    body_tokens: List[Tok]
    parsed: bool

    @property
    def returns_object(self) -> bool:
        ids = {t.value for t in self.ret_tokens if t.kind == "id"}
        return "PyObject" in ids or "PyMODINIT_FUNC" in ids


_KEYWORDS = {
    "if", "else", "while", "for", "do", "switch", "case", "default",
    "return", "break", "continue", "goto", "sizeof", "static", "const",
    "struct", "enum", "union", "typedef", "extern", "inline", "void",
}

_GIL_BEGIN = "Py_BEGIN_ALLOW_THREADS"
_GIL_END = "Py_END_ALLOW_THREADS"
_PY_RETURN_MACROS = {
    "Py_RETURN_NONE", "Py_RETURN_TRUE", "Py_RETURN_FALSE",
    "Py_RETURN_NOTIMPLEMENTED",
}


class _Parser:
    """Statement parser over a token slice (one function body)."""

    def __init__(self, toks: List[Tok]):
        self.toks = toks
        self.i = 0
        self.n = len(toks)

    def peek(self, k: int = 0) -> Optional[Tok]:
        j = self.i + k
        return self.toks[j] if j < self.n else None

    def _run_to(self, closers: str, openers: str) -> List[Tok]:
        """Consume a balanced token run ending just before a top-level
        occurrence of any char in *closers*; tracks () and {} depth."""
        out: List[Tok] = []
        pd = bd = 0
        while self.i < self.n:
            t = self.toks[self.i]
            if t.kind == "punct":
                if pd == 0 and bd == 0 and t.value in closers:
                    return out
                if t.value == "(":
                    pd += 1
                elif t.value == ")":
                    pd -= 1
                elif t.value == "{":
                    bd += 1
                elif t.value == "}":
                    bd -= 1
            out.append(t)
            self.i += 1
        return out

    def _paren_run(self) -> List[Tok]:
        """Consume '( ... )' and return the inner tokens."""
        assert self.toks[self.i].value == "("
        self.i += 1
        out: List[Tok] = []
        depth = 0
        while self.i < self.n:
            t = self.toks[self.i]
            if t.kind == "punct":
                if t.value == "(":
                    depth += 1
                elif t.value == ")":
                    if depth == 0:
                        self.i += 1
                        return out
                    depth -= 1
            out.append(t)
            self.i += 1
        return out

    def block(self) -> List[Stmt]:
        """Parse '{ ... }' (current token is '{')."""
        assert self.toks[self.i].value == "{"
        self.i += 1
        out: List[Stmt] = []
        while self.i < self.n:
            t = self.toks[self.i]
            if t.kind == "punct" and t.value == "}":
                self.i += 1
                return out
            s = self.stmt()
            if s is not None:
                out.append(s)
        return out

    def stmt(self) -> Optional[Stmt]:
        t = self.peek()
        if t is None:
            return None
        if t.kind == "punct" and t.value == ";":
            self.i += 1
            return None
        if t.kind == "punct" and t.value == "{":
            line = t.line
            return Stmt("Block", line, body=self.block())
        if t.kind == "id":
            v = t.value
            if v == _GIL_BEGIN or v == _GIL_END:
                self.i += 1
                if self.peek() and self.peek().value == ";":
                    self.i += 1
                return Stmt(
                    "Gil", t.line, marker="begin" if v == _GIL_BEGIN else "end"
                )
            if v in _PY_RETURN_MACROS:
                self.i += 1
                if self.peek() and self.peek().value == ";":
                    self.i += 1
                return Stmt("Return", t.line, tokens=[t], marker=v)
            if v == "if":
                self.i += 1
                cond = self._paren_run()
                then = self._sub_stmts()
                orelse: List[Stmt] = []
                nxt = self.peek()
                if nxt and nxt.kind == "id" and nxt.value == "else":
                    self.i += 1
                    orelse = self._sub_stmts()
                return Stmt("If", t.line, cond=cond, body=then, orelse=orelse)
            if v == "while":
                self.i += 1
                cond = self._paren_run()
                body = self._sub_stmts()
                return Stmt("Loop", t.line, cond=cond, body=body)
            if v == "do":
                self.i += 1
                body = self._sub_stmts()
                nxt = self.peek()
                cond: List[Tok] = []
                if nxt and nxt.kind == "id" and nxt.value == "while":
                    self.i += 1
                    cond = self._paren_run()
                    if self.peek() and self.peek().value == ";":
                        self.i += 1
                return Stmt("Loop", t.line, cond=cond, body=body)
            if v == "for":
                self.i += 1
                inner = self._paren_run()
                init, cond, step = _split_for(inner)
                body = self._sub_stmts()
                return Stmt(
                    "Loop", t.line, cond=cond, body=body, init=init, step=step
                )
            if v == "switch":
                self.i += 1
                cond = self._paren_run()
                cases = self._switch_cases()
                return Stmt("Switch", t.line, cond=cond, cases=cases)
            if v == "return":
                self.i += 1
                toks = self._run_to(";", "")
                if self.peek() and self.peek().value == ";":
                    self.i += 1
                return Stmt("Return", t.line, tokens=toks)
            if v == "break" or v == "continue":
                self.i += 1
                if self.peek() and self.peek().value == ";":
                    self.i += 1
                return Stmt("Break" if v == "break" else "Continue", t.line)
            if v == "goto":
                self.i += 1
                name = ""
                if self.peek() and self.peek().kind == "id":
                    name = self.peek().value
                    self.i += 1
                if self.peek() and self.peek().value == ";":
                    self.i += 1
                return Stmt("Goto", t.line, marker=name)
            nxt = self.peek(1)
            if (
                nxt is not None
                and nxt.kind == "punct"
                and nxt.value == ":"
                and v not in _KEYWORDS
            ):
                # label (case/default handled inside _switch_cases)
                self.i += 2
                return Stmt("Label", t.line, marker=v)
        # plain expression statement
        toks = self._run_to(";", "")
        if self.peek() and self.peek().value == ";":
            self.i += 1
        if not toks:
            return None
        return Stmt("Expr", toks[0].line, tokens=toks)

    def _sub_stmts(self) -> List[Stmt]:
        """A single statement or a block, normalized to a list."""
        t = self.peek()
        if t is not None and t.kind == "punct" and t.value == "{":
            return self.block()
        s = self.stmt()
        return [s] if s is not None else []

    def _switch_cases(self) -> List[Tuple[List[List[Tok]], List[Stmt]]]:
        t = self.peek()
        if t is None or t.value != "{":
            return []
        self.i += 1
        cases: List[Tuple[List[List[Tok]], List[Stmt]]] = []
        labels: List[List[Tok]] = []
        stmts: List[Stmt] = []

        def flush():
            nonlocal labels, stmts
            if labels:
                cases.append((labels, stmts))
            labels, stmts = [], []

        while self.i < self.n:
            t = self.peek()
            if t is None:
                break
            if t.kind == "punct" and t.value == "}":
                self.i += 1
                break
            if t.kind == "id" and t.value in ("case", "default"):
                if stmts:
                    flush()
                self.i += 1
                lab = self._run_to(":", "") if t.value == "case" else []
                if self.peek() and self.peek().value == ":":
                    self.i += 1
                labels.append(lab)
                continue
            s = self.stmt()
            if s is not None:
                stmts.append(s)
        flush()
        return cases


def _split_for(inner: List[Tok]) -> Tuple[List[Tok], List[Tok], List[Tok]]:
    """Split for(init; cond; step) inner tokens at top-level ';'."""
    parts: List[List[Tok]] = [[]]
    depth = 0
    for t in inner:
        if t.kind == "punct":
            if t.value in "([{":
                depth += 1
            elif t.value in ")]}":
                depth -= 1
            elif t.value == ";" and depth == 0:
                parts.append([])
                continue
        parts[-1].append(t)
    while len(parts) < 3:
        parts.append([])
    return parts[0], parts[1], parts[2]


# ---------------------------------------------------------------------------
# function extraction
# ---------------------------------------------------------------------------


def extract_functions(toks: List[Tok]) -> List[CFunc]:
    """Find top-level function definitions: ``ID ( params ) {``."""
    funcs: List[CFunc] = []
    depth = 0
    i = 0
    n = len(toks)
    while i < n:
        t = toks[i]
        if t.kind == "punct" and t.value == "{":
            # skip depth bump for extern "C" { / namespace [id] {
            is_linkage = False
            if i >= 2 and toks[i - 1].kind == "str" and toks[i - 2].value == "extern":
                is_linkage = True
            if i >= 1 and toks[i - 1].kind == "id" and toks[i - 1].value == "namespace":
                is_linkage = True
            if (
                i >= 2
                and toks[i - 2].kind == "id"
                and toks[i - 2].value == "namespace"
                and toks[i - 1].kind == "id"
            ):
                is_linkage = True
            if is_linkage:
                i += 1
                continue
            if depth == 0 and i >= 1 and toks[i - 1].value == ")":
                fn = _try_extract_function(toks, i)
                if fn is not None:
                    funcs.append(fn)
                    # skip past the body we just captured
                    i += 1
                    d = 1
                    while i < n and d > 0:
                        if toks[i].kind == "punct":
                            if toks[i].value == "{":
                                d += 1
                            elif toks[i].value == "}":
                                d -= 1
                        i += 1
                    continue
            depth += 1
            i += 1
            continue
        if t.kind == "punct" and t.value == "}":
            depth = max(0, depth - 1)
            i += 1
            continue
        i += 1
    return funcs


def _try_extract_function(toks: List[Tok], brace_i: int) -> Optional[CFunc]:
    # match ')' at brace_i-1 back to its '('
    j = brace_i - 1
    depth = 0
    while j >= 0:
        t = toks[j]
        if t.kind == "punct":
            if t.value == ")":
                depth += 1
            elif t.value == "(":
                depth -= 1
                if depth == 0:
                    break
        j -= 1
    if j <= 0:
        return None
    open_i = j
    name_t = toks[open_i - 1]
    if name_t.kind != "id" or name_t.value in _KEYWORDS:
        return None
    # return-type tokens: from previous ';' or '}' up to the name
    k = open_i - 2
    ret_start = 0
    while k >= 0:
        t = toks[k]
        if t.kind == "punct" and t.value in (";", "}"):
            ret_start = k + 1
            break
        k -= 1
    ret_tokens = toks[ret_start : open_i - 1]
    if not ret_tokens:
        return None  # `foo() {` with no return type isn't a definition here
    params_toks = toks[open_i + 1 : brace_i - 1]
    params, pyobj = _parse_params(params_toks)
    # capture body tokens
    i = brace_i + 1
    d = 1
    body_start = i
    n = len(toks)
    while i < n and d > 0:
        if toks[i].kind == "punct":
            if toks[i].value == "{":
                d += 1
            elif toks[i].value == "}":
                d -= 1
        i += 1
    body_tokens = toks[body_start : i - 1]
    body: List[Stmt] = []
    parsed = True
    try:
        body = _Parser(body_tokens).block_free()
    except Exception:
        parsed = False
        body = []
    return CFunc(
        name=name_t.value,
        line=name_t.line,
        params=params,
        pyobject_params=pyobj,
        ret_tokens=ret_tokens,
        body=body,
        body_tokens=body_tokens,
        parsed=parsed,
    )


def _parser_block_free(self: _Parser) -> List[Stmt]:
    out: List[Stmt] = []
    while self.i < self.n:
        s = self.stmt()
        if s is not None:
            out.append(s)
    return out


_Parser.block_free = _parser_block_free  # type: ignore[attr-defined]


def _parse_params(params_toks: List[Tok]) -> Tuple[List[str], Set[str]]:
    parts: List[List[Tok]] = [[]]
    depth = 0
    for t in params_toks:
        if t.kind == "punct":
            if t.value in "([{":
                depth += 1
            elif t.value in ")]}":
                depth -= 1
            elif t.value == "," and depth == 0:
                parts.append([])
                continue
        parts[-1].append(t)
    names: List[str] = []
    pyobj: Set[str] = set()
    for part in parts:
        ids = [t for t in part if t.kind == "id"]
        if not ids:
            continue
        # name = last id, skipping array-bracket contents
        name = None
        skip = 0
        for t in reversed(part):
            if t.kind == "punct" and t.value == "]":
                skip += 1
            elif t.kind == "punct" and t.value == "[":
                skip -= 1
            elif t.kind == "id" and skip == 0:
                name = t.value
                break
        if name is None or name in ("void",):
            continue
        names.append(name)
        if any(t.value == "PyObject" for t in ids):
            pyobj.add(name)
    return names, pyobj


# ---------------------------------------------------------------------------
# refcount analysis
# ---------------------------------------------------------------------------

# CPython calls returning NEW references
NEW_REF = {
    "PyBytes_FromStringAndSize", "PyUnicode_DecodeUTF8",
    "PyUnicode_InternFromString", "PyUnicode_FromString",
    "PyLong_FromLong", "PyLong_FromLongLong", "PyLong_FromUnsignedLong",
    "PyLong_FromUnsignedLongLong", "PyLong_FromSsize_t",
    "PyLong_FromSize_t", "PyFloat_FromDouble",
    "PyList_New", "PyTuple_New", "PyDict_New",
    "PyObject_GetAttr", "PyObject_GetAttrString",
    "PyObject_Call", "PyObject_CallObject", "PyObject_CallFunction",
    "PyObject_CallMethod", "PyObject_CallNoArgs",
    "PySequence_Fast", "PySequence_GetItem", "PySequence_Tuple",
    "PySequence_List", "PyNumber_Negative", "PyNumber_Index",
    "PyErr_NewException", "PyModule_Create", "PyImport_ImportModule",
    "Py_BuildValue", "PyDict_Copy", "PyObject_Str", "PyObject_Repr",
}

# CPython calls returning BORROWED references
BORROWED_REF = {
    "PyList_GET_ITEM", "PyTuple_GET_ITEM", "PySequence_Fast_GET_ITEM",
    "PyDict_GetItem", "PyDict_GetItemString", "PyList_GetItem",
    "PyTuple_GetItem",
}

# calls that STEAL a reference at the given 1-based argument positions
STEALS = {
    "PyList_SET_ITEM": (3,),
    "PyTuple_SET_ITEM": (3,),
    "PyList_SetItem": (3,),
    "PyTuple_SetItem": (3,),
    "PyModule_AddObject": (3,),
    "Py_XSETREF": (2,),
    "Py_SETREF": (2,),
}

# calls with NO refcount effect on their object arguments (and any
# identifier with these prefixes/suffixes) -- keeps tracking precise
KNOWN_SAFE = {
    "PyBuffer_Release", "PyErr_SetString", "PyErr_Format", "PyErr_Clear",
    "PyErr_Occurred", "PyErr_SetObject", "PyErr_ExceptionMatches",
    "PyList_Append", "PyDict_SetItem", "PyDict_SetItemString",
    "PyObject_SetAttr", "PyObject_SetAttrString", "PyDict_Next",
    "PySequence_Size", "PyObject_Length", "PyObject_Size",
    "PyObject_IsInstance", "PyObject_IsTrue", "PyObject_RichCompareBool",
    "PyLong_AsLong", "PyLong_AsLongLong", "PyLong_AsUnsignedLong",
    "PyLong_AsUnsignedLongLong", "PyLong_AsSsize_t",
    "PyLong_AsUnsignedLongLongMask", "PyFloat_AsDouble",
    "PyUnicode_AsUTF8AndSize", "PyUnicode_AsUTF8",
    "PyObject_GetBuffer", "PyObject_CheckBuffer",
    "PyBytes_GET_SIZE", "PyBytes_AS_STRING", "PyBytes_AsString",
    "PyByteArray_GET_SIZE", "PyByteArray_AS_STRING", "PyByteArray_Size",
    "PySequence_Fast_GET_SIZE", "PySequence_Fast_ITEMS",
    "PyList_GET_SIZE", "PyTuple_GET_SIZE",
    "PyList_Size", "PyTuple_Size", "PyDict_Size",
    "Py_EnterRecursiveCall", "Py_LeaveRecursiveCall", "PyType_Ready",
    "PyErr_NoMemory", "PyErr_WarnEx",
    "memcpy", "memset", "memmove", "strcmp", "strlen", "free", "malloc",
    "realloc",
}

_SAFE_PREFIXES = ("PyMem_",)
_SAFE_SUFFIXES = ("_Check", "_CheckExact")

# refcount-state lattice
UNINIT = "uninit"
NULLVAL = "null"
BORROWED = "borrowed"
OWNED = "owned"
OWNED_MAYBENULL = "owned?"
UNOWNED = "unowned"
UNTRACKED = "untracked"

_OWNEDISH = (OWNED, OWNED_MAYBENULL)


@dataclass(frozen=True)
class RefLeak:
    var: str
    creation_line: int
    exit_line: int


@dataclass(frozen=True)
class GilViolation:
    call: str
    line: int


# GIL-safe identifiers that may appear inside an ALLOW_THREADS region
_GIL_SAFE_EXACT = {
    "PyBytes_AS_STRING", "PyBytes_GET_SIZE", "PyByteArray_AS_STRING",
    "PyByteArray_GET_SIZE", "PyEval_SaveThread", "PyEval_RestoreThread",
    "Py_BEGIN_ALLOW_THREADS", "Py_END_ALLOW_THREADS",
    "Py_BLOCK_THREADS", "Py_UNBLOCK_THREADS",
}
_GIL_SAFE_PREFIXES = ("PyMem_Raw",)


def gil_violations(fn: CFunc) -> List[GilViolation]:
    """Python C-API calls between BEGIN/END_ALLOW_THREADS markers."""
    out: List[GilViolation] = []
    toks = fn.body_tokens
    inside = False
    for i, t in enumerate(toks):
        if t.kind != "id":
            continue
        if t.value == _GIL_BEGIN:
            inside = True
            continue
        if t.value == _GIL_END:
            inside = False
            continue
        if not inside:
            continue
        if not (t.value.startswith("Py") or t.value.startswith("_Py")):
            continue
        nxt = toks[i + 1] if i + 1 < len(toks) else None
        if nxt is None or nxt.value != "(":
            continue
        if t.value in _GIL_SAFE_EXACT:
            continue
        if any(t.value.startswith(p) for p in _GIL_SAFE_PREFIXES):
            continue
        out.append(GilViolation(call=t.value, line=t.line))
    return out


# --- refcount CFG ---------------------------------------------------------


class _RC:
    """Refcount dataflow over one function."""

    def __init__(self, fn: CFunc, model: "NativeModel"):
        self.fn = fn
        self.model = model
        self.leaks: List[RefLeak] = []
        self._seen: Set[Tuple[str, int, int]] = set()
        # tracked variable universe: PyObject* locals and params
        self.tracked: Set[str] = set(fn.pyobject_params)
        self._collect_decls(fn.body)

    def _collect_decls(self, stmts: Sequence[Stmt]) -> None:
        for s in stmts:
            if s.kind == "Expr":
                self._decls_in_tokens(s.tokens)
            elif s.kind == "Loop":
                self._decls_in_tokens(s.init)
                self._collect_decls(s.body)
            elif s.kind in ("Block",):
                self._collect_decls(s.body)
            elif s.kind == "If":
                self._collect_decls(s.body)
                self._collect_decls(s.orelse)
            elif s.kind == "Switch":
                for _labs, body in s.cases:
                    self._collect_decls(body)

    def _decls_in_tokens(self, toks: List[Tok]) -> None:
        # `PyObject * name [= ...][, * name2 [= ...]]*`
        if not toks or toks[0].kind != "id" or toks[0].value != "PyObject":
            return
        i = 1
        depth = 0
        expect_name = True
        while i < len(toks):
            t = toks[i]
            if t.kind == "punct":
                if t.value in "([{":
                    depth += 1
                elif t.value in ")]}":
                    depth -= 1
                elif t.value == "," and depth == 0:
                    expect_name = True
                elif t.value == "=" and depth == 0:
                    expect_name = False
            elif t.kind == "id" and expect_name and depth == 0:
                self.tracked.add(t.value)
                expect_name = False
            i += 1

    # -- state ops --

    def _initial(self) -> Dict[str, Tuple[str, int]]:
        st: Dict[str, Tuple[str, int]] = {}
        for v in self.tracked:
            if v in self.fn.pyobject_params:
                st[v] = (BORROWED, self.fn.line)
            else:
                st[v] = (UNINIT, self.fn.line)
        return st

    @staticmethod
    def _join(
        a: Dict[str, Tuple[str, int]], b: Dict[str, Tuple[str, int]]
    ) -> Dict[str, Tuple[str, int]]:
        out: Dict[str, Tuple[str, int]] = {}
        for v in set(a) | set(b):
            sa = a.get(v, (UNINIT, 0))
            sb = b.get(v, (UNINIT, 0))
            if sa == sb:
                out[v] = sa
                continue
            ta, tb = sa[0], sb[0]
            line = min(x for x in (sa[1], sb[1]) if x) if (sa[1] or sb[1]) else 0
            if ta == UNTRACKED or tb == UNTRACKED:
                out[v] = (UNTRACKED, line)
            elif ta in _OWNEDISH or tb in _OWNEDISH:
                if ta == OWNED and tb == OWNED:
                    out[v] = (OWNED, line)
                else:
                    out[v] = (OWNED_MAYBENULL, line)
            else:
                out[v] = (UNOWNED, line)
        return out

    # -- call-effect helpers --

    def _apply_call_effects(
        self, toks: List[Tok], st: Dict[str, Tuple[str, int]]
    ) -> None:
        """Scan tokens for calls and apply steal/consume/untrack effects
        to tracked arguments.  Assignment handling is separate."""
        i = 0
        n = len(toks)
        while i < n:
            t = toks[i]
            if t.kind == "id" and i + 1 < n and toks[i + 1].value == "(":
                name = t.value
                args = _call_args(toks, i + 1)
                if name in ("Py_INCREF", "Py_XINCREF"):
                    v = _single_id(args[0]) if args else None
                    if v in self.tracked:
                        cur = st.get(v, (UNINIT, t.line))
                        if name == "Py_XINCREF" and cur[0] in (
                            OWNED_MAYBENULL, NULLVAL, UNINIT,
                        ):
                            st[v] = (OWNED_MAYBENULL, t.line)
                        else:
                            st[v] = (OWNED, t.line)
                elif name in ("Py_DECREF", "Py_XDECREF", "Py_CLEAR"):
                    v = _single_id(args[0]) if args else None
                    if v in self.tracked:
                        st[v] = (UNOWNED, t.line)
                elif name in STEALS:
                    for pos in STEALS[name]:
                        if pos - 1 < len(args):
                            v = _single_id(args[pos - 1])
                            if v in self.tracked:
                                st[v] = (UNOWNED, t.line)
                elif name == "Py_BuildValue":
                    self._build_value(args, st, t.line)
                elif name in (
                    "PyArg_ParseTuple", "PyArg_ParseTupleAndKeywords",
                ):
                    for a in args:
                        v = _addr_of_id(a)
                        if v in self.tracked:
                            st[v] = (BORROWED, t.line)
                elif (
                    name in KNOWN_SAFE
                    or name in NEW_REF
                    or name in BORROWED_REF
                    or any(name.startswith(p) for p in _SAFE_PREFIXES)
                    or any(name.endswith(sfx) for sfx in _SAFE_SUFFIXES)
                ):
                    pass  # no effect on argument ownership
                else:
                    callee = self.model.functions.get(name)
                    if callee is not None:
                        consumed = self.model.may_consume(name)
                        for idx, a in enumerate(args):
                            v = _single_id(a)
                            if v in self.tracked and idx < len(callee.params):
                                if callee.params[idx] in consumed:
                                    st[v] = (UNTRACKED, t.line)
                    else:
                        # unknown call/macro: any tracked arg escapes
                        for a in args:
                            v = _single_id(a) or _addr_of_id(a)
                            if v in self.tracked:
                                st[v] = (UNTRACKED, t.line)
                # skip past the whole call
                i = _skip_call(toks, i + 1)
                continue
            i += 1

    def _build_value(
        self,
        args: List[List[Tok]],
        st: Dict[str, Tuple[str, int]],
        line: int,
    ) -> None:
        if not args or not args[0] or args[0][0].kind != "str":
            # unknown format: be conservative, untrack all id args
            for a in args[1:]:
                v = _single_id(a)
                if v in self.tracked:
                    st[v] = (UNTRACKED, line)
            return
        fmt = args[0][0].value
        argi = 1
        for ch in fmt:
            if ch in "([{)]} ,:":
                continue
            if ch == "#":
                argi += 1  # consumes an extra length arg
                continue
            if ch in "ONS":
                if argi < len(args):
                    v = _single_id(args[argi])
                    if ch in ("N", "S") and v in self.tracked:
                        st[v] = (UNOWNED, line)
                argi += 1
                continue
            argi += 1

    def _rhs_state(
        self, rhs: List[Tok], st: Dict[str, Tuple[str, int]], line: int
    ) -> Tuple[str, int]:
        ids = [t for t in rhs if t.kind == "id"]
        if len(rhs) == 1 and rhs[0].kind == "id":
            v = rhs[0].value
            if v == "NULL":
                return (NULLVAL, line)
            if v in ("Py_None", "Py_True", "Py_False", "Py_NotImplemented"):
                return (BORROWED, line)
            if v in self.tracked:
                return st.get(v, (UNTRACKED, line))
            return (BORROWED, line)  # module-level global
        if len(rhs) == 1 and rhs[0].kind == "num":
            return (NULLVAL, line) if rhs[0].value == "0" else (UNTRACKED, line)
        # scan calls in the RHS
        has_new = has_borrowed = False
        i = 0
        while i < len(rhs):
            t = rhs[i]
            if t.kind == "id" and i + 1 < len(rhs) and rhs[i + 1].value == "(":
                name = t.value
                if name in NEW_REF:
                    has_new = True
                elif name in BORROWED_REF:
                    has_borrowed = True
                else:
                    callee = self.model.functions.get(name)
                    if callee is not None and callee.returns_object:
                        has_new = True
            i += 1
        if has_new:
            return (OWNED_MAYBENULL, line)
        if has_borrowed:
            return (BORROWED, line)
        if not ids:
            return (UNTRACKED, line)
        return (UNTRACKED, line)

    # -- error exits --

    @staticmethod
    def _is_error_return(toks: List[Tok], marker: str) -> bool:
        if marker in _PY_RETURN_MACROS:
            return False
        vals = [t.value for t in toks if not (t.kind == "id" and t.value == "return")]
        if vals == ["NULL"]:
            return True
        if vals == ["-", "1"]:
            return True
        if vals and vals[0] == "PyErr_NoMemory":
            return True
        return False

    def _report_exit(
        self, st: Dict[str, Tuple[str, int]], exit_line: int
    ) -> None:
        for v, (tag, cline) in sorted(st.items()):
            if tag in _OWNEDISH:
                key = (v, cline, exit_line)
                if key not in self._seen:
                    self._seen.add(key)
                    self.leaks.append(
                        RefLeak(var=v, creation_line=cline, exit_line=exit_line)
                    )

    # -- condition refinement --

    def _cond_facts(
        self, cond: List[Tok]
    ) -> Tuple[List[Tuple[str, str]], List[Tuple[str, str]]]:
        """Return (true_facts, false_facts): lists of (var, 'null'|'nonnull')
        that hold on the respective branch.  Conservative: only simple
        null-test shapes produce facts."""
        return _cond_facts_rec(cond, self.tracked)

    @staticmethod
    def _refine(
        st: Dict[str, Tuple[str, int]], facts: List[Tuple[str, str]]
    ) -> Dict[str, Tuple[str, int]]:
        if not facts:
            return st
        out = dict(st)
        for v, what in facts:
            cur = out.get(v)
            if cur is None:
                continue
            tag, line = cur
            if what == "null" and tag == OWNED_MAYBENULL:
                out[v] = (NULLVAL, line)
            elif what == "nonnull":
                if tag == OWNED_MAYBENULL:
                    out[v] = (OWNED, line)
                elif tag == NULLVAL:
                    out[v] = (UNOWNED, line)  # dead path
        return out

    # -- interpreter --

    def run(self) -> List[RefLeak]:
        if not self.fn.parsed or not self.tracked:
            return []
        try:
            self._exec_seq(self.fn.body, self._initial(), depth=0)
        except _Bail:
            return []
        except RecursionError:
            return []
        return self.leaks

    def _exec_seq(
        self,
        stmts: Sequence[Stmt],
        st: Dict[str, Tuple[str, int]],
        depth: int,
        labels: Optional[Dict[str, Tuple[Sequence[Stmt], int]]] = None,
    ) -> Optional[Dict[str, Tuple[str, int]]]:
        """Execute statements; returns the fall-through state or None if
        all paths terminated (return/goto).  Branches are explored by
        recursive path enumeration with a depth cap."""
        if depth > 64:
            raise _Bail()
        if labels is None:
            labels = _collect_labels(stmts)
        i = 0
        while i < len(stmts):
            s = stmts[i]
            rest = stmts[i + 1 :]
            if s.kind == "Expr":
                self._exec_expr(s.tokens, st)
                i += 1
                continue
            if s.kind == "Gil":
                i += 1
                continue
            if s.kind == "Label":
                i += 1
                continue
            if s.kind == "Block":
                sub = self._exec_seq(s.body, st, depth + 1, labels)
                if sub is None:
                    return None
                st = sub
                i += 1
                continue
            if s.kind == "Return":
                # apply call effects in the return expression first
                expr = [
                    t
                    for t in s.tokens
                    if not (t.kind == "id" and t.value == "return")
                ]
                self._apply_call_effects(expr, st)
                v = _returned_var(expr)
                if v in self.tracked:
                    st = dict(st)
                    st[v] = (UNOWNED, s.line)
                if self._is_error_return(s.tokens, s.marker):
                    self._report_exit(st, s.line)
                return None
            if s.kind == "Goto":
                target = labels.get(s.marker)
                if target is None:
                    # unknown label: treat as terminating without report
                    return None
                tstmts, ti = target
                self._exec_seq(tstmts[ti:], st, depth + 1, labels)
                return None
            if s.kind in ("Break", "Continue"):
                return dict(st)  # loop bodies are executed once; fall out
            if s.kind == "If":
                self._apply_call_effects(s.cond, st)
                tf, ff = self._cond_facts(s.cond)
                st_t = self._refine(dict(st), tf)
                st_f = self._refine(dict(st), ff)
                out_t = self._exec_seq(
                    list(s.body) + list(rest), st_t, depth + 1, labels
                )
                out_f = self._exec_seq(
                    list(s.orelse) + list(rest), st_f, depth + 1, labels
                )
                if out_t is None and out_f is None:
                    return None
                if out_t is None:
                    return out_f
                if out_f is None:
                    return out_t
                return self._join(out_t, out_f)
            if s.kind == "Loop":
                self._apply_call_effects(s.init, st)
                self._decl_assigns(s.init, st)
                self._apply_call_effects(s.cond, st)
                # run the body once (conservative single unrolling),
                # then join with the skip path
                body_out = self._exec_seq(list(s.body), dict(st), depth + 1, labels)
                self._apply_call_effects(s.step, st)
                if body_out is not None:
                    self._apply_call_effects(s.step, body_out)
                    st = self._join(st, body_out)
                i += 1
                continue
            if s.kind == "Switch":
                self._apply_call_effects(s.cond, st)
                outs: List[Dict[str, Tuple[str, int]]] = []
                any_falls = False
                for _labs, body in s.cases:
                    o = self._exec_seq(list(body), dict(st), depth + 1, labels)
                    if o is not None:
                        outs.append(o)
                        any_falls = True
                if not s.cases:
                    any_falls = True
                    outs.append(dict(st))
                if not any_falls:
                    # no default branch may still fall through
                    has_default = any(
                        any(not lab for lab in labs) for labs, _b in s.cases
                    )
                    if not has_default:
                        outs.append(dict(st))
                if not outs:
                    return None
                acc = outs[0]
                for o in outs[1:]:
                    acc = self._join(acc, o)
                st = acc
                i += 1
                continue
            i += 1
        return st

    def _decl_assigns(
        self, toks: List[Tok], st: Dict[str, Tuple[str, int]]
    ) -> None:
        """Handle assignments inside for-init token runs."""
        self._exec_expr(toks, st)

    def _exec_expr(self, toks: List[Tok], st: Dict[str, Tuple[str, int]]) -> None:
        # declaration with (possibly several) declarators:
        #   PyObject *a = X, *b = Y;
        if toks and toks[0].kind == "id" and toks[0].value == "PyObject":
            for part in _split_top(toks[1:], ","):
                eq = None
                depth = 0
                for i, t in enumerate(part):
                    if t.kind == "punct":
                        if t.value in "([{":
                            depth += 1
                        elif t.value in ")]}":
                            depth -= 1
                        elif t.value == "=" and depth == 0:
                            eq = i
                            break
                if eq is None:
                    continue
                name = None
                for t in part[:eq]:
                    if t.kind == "id":
                        name = t.value
                rhs = part[eq + 1 :]
                self._apply_call_effects(rhs, st)
                if name in self.tracked:
                    st[name] = self._rhs_state(
                        _strip_casts(rhs), st, part[0].line if part else 0
                    )
            return
        # plain assignment: `name = RHS` (single top-level '=')
        eq_i = None
        depth = 0
        for i, t in enumerate(toks):
            if t.kind == "punct":
                if t.value in "([{":
                    depth += 1
                elif t.value in ")]}":
                    depth -= 1
                elif t.value == "=" and depth == 0:
                    eq_i = i
                    break
        if eq_i is not None:
            lhs = toks[:eq_i]
            rhs = toks[eq_i + 1 :]
            target = None
            for t in reversed(lhs):
                if t.kind == "id":
                    target = t.value
                    break
                if t.kind == "punct" and t.value in ("*", "const"):
                    continue
                break
            self._apply_call_effects(rhs, st)
            if target in self.tracked:
                st[target] = self._rhs_state(
                    _strip_casts(rhs), st, toks[0].line
                )
            return
        self._apply_call_effects(toks, st)


class _Bail(Exception):
    pass


def _collect_labels(
    stmts: Sequence[Stmt],
) -> Dict[str, Tuple[Sequence[Stmt], int]]:
    labels: Dict[str, Tuple[Sequence[Stmt], int]] = {}

    def walk(seq: Sequence[Stmt]) -> None:
        for i, s in enumerate(seq):
            if s.kind == "Label":
                labels[s.marker] = (seq, i + 1)
            if s.kind in ("Block", "If", "Loop"):
                walk(s.body)
            if s.kind == "If":
                walk(s.orelse)
            if s.kind == "Switch":
                for _labs, body in s.cases:
                    walk(body)

    walk(stmts)
    return labels


def _call_args(toks: List[Tok], open_i: int) -> List[List[Tok]]:
    """Split the args of the call whose '(' is at open_i."""
    args: List[List[Tok]] = [[]]
    depth = 0
    i = open_i + 1
    while i < len(toks):
        t = toks[i]
        if t.kind == "punct":
            if t.value == "(":
                depth += 1
            elif t.value == ")":
                if depth == 0:
                    break
                depth -= 1
            elif t.value == "," and depth == 0:
                args.append([])
                i += 1
                continue
        args[-1].append(t)
        i += 1
    if args == [[]]:
        return []
    return args


def _skip_call(toks: List[Tok], open_i: int) -> int:
    """Index just past the ')' matching the '(' at open_i."""
    depth = 0
    i = open_i
    while i < len(toks):
        t = toks[i]
        if t.kind == "punct":
            if t.value == "(":
                depth += 1
            elif t.value == ")":
                depth -= 1
                if depth == 0:
                    return i + 1
        i += 1
    return i


def _single_id(toks: List[Tok]) -> Optional[str]:
    toks = _strip_casts(toks)
    if len(toks) == 1 and toks[0].kind == "id":
        return toks[0].value
    return None


def _addr_of_id(toks: List[Tok]) -> Optional[str]:
    if (
        len(toks) == 2
        and toks[0].kind == "punct"
        and toks[0].value == "&"
        and toks[1].kind == "id"
    ):
        return toks[1].value
    return None


def _strip_casts(toks: List[Tok]) -> List[Tok]:
    """Strip a leading `( type... * )` cast."""
    if (
        len(toks) >= 3
        and toks[0].kind == "punct"
        and toks[0].value == "("
    ):
        depth = 0
        for i, t in enumerate(toks):
            if t.kind == "punct":
                if t.value == "(":
                    depth += 1
                elif t.value == ")":
                    depth -= 1
                    if depth == 0:
                        inner = toks[1:i]
                        rest = toks[i + 1 :]
                        if rest and all(
                            t2.kind == "id" or t2.value in ("*", "const")
                            for t2 in inner
                        ):
                            return _strip_casts(rest)
                        return toks
        return toks
    return toks


def _returned_var(expr: List[Tok]) -> Optional[str]:
    return _single_id(expr)


def _cond_facts_rec(
    cond: List[Tok], tracked: Set[str]
) -> Tuple[List[Tuple[str, str]], List[Tuple[str, str]]]:
    cond = _strip_outer_parens(cond)
    if not cond:
        return [], []
    # split on top-level || first (lowest precedence), then &&
    or_parts = _split_top(cond, "||")
    if len(or_parts) > 1:
        # true-branch: nothing certain; false-branch: all disjuncts false
        false_facts: List[Tuple[str, str]] = []
        for p in or_parts:
            _t, f = _cond_facts_rec(p, tracked)
            false_facts.extend(f)
        return [], false_facts
    and_parts = _split_top(cond, "&&")
    if len(and_parts) > 1:
        true_facts: List[Tuple[str, str]] = []
        for p in and_parts:
            t, _f = _cond_facts_rec(p, tracked)
            true_facts.extend(t)
        return true_facts, []
    # atoms
    vals = [t.value for t in cond]
    if (
        len(cond) == 3
        and cond[1].value == "=="
        and (
            (cond[0].kind == "id" and cond[2].value == "NULL")
            or (cond[2].kind == "id" and cond[0].value == "NULL")
        )
    ):
        v = cond[0].value if cond[2].value == "NULL" else cond[2].value
        if v in tracked:
            return [(v, "null")], [(v, "nonnull")]
        return [], []
    if (
        len(cond) == 3
        and cond[1].value == "!="
        and (
            (cond[0].kind == "id" and cond[2].value == "NULL")
            or (cond[2].kind == "id" and cond[0].value == "NULL")
        )
    ):
        v = cond[0].value if cond[2].value == "NULL" else cond[2].value
        if v in tracked:
            return [(v, "nonnull")], [(v, "null")]
        return [], []
    if len(cond) == 2 and vals[0] == "!" and cond[1].kind == "id":
        v = cond[1].value
        if v in tracked:
            return [(v, "null")], [(v, "nonnull")]
        return [], []
    if len(cond) == 1 and cond[0].kind == "id":
        v = cond[0].value
        if v in tracked:
            return [(v, "nonnull")], [(v, "null")]
    return [], []


def _strip_outer_parens(toks: List[Tok]) -> List[Tok]:
    while (
        len(toks) >= 2
        and toks[0].value == "("
        and toks[-1].value == ")"
    ):
        depth = 0
        balanced = True
        for i, t in enumerate(toks):
            if t.kind == "punct":
                if t.value == "(":
                    depth += 1
                elif t.value == ")":
                    depth -= 1
                    if depth == 0 and i != len(toks) - 1:
                        balanced = False
                        break
        if not balanced:
            return toks
        toks = toks[1:-1]
    return toks


def _split_top(toks: List[Tok], op: str) -> List[List[Tok]]:
    parts: List[List[Tok]] = [[]]
    depth = 0
    for t in toks:
        if t.kind == "punct":
            if t.value in "([{":
                depth += 1
            elif t.value in ")]}":
                depth -= 1
            elif t.value == op and depth == 0:
                parts.append([])
                continue
        parts[-1].append(t)
    return parts


# ---------------------------------------------------------------------------
# wire-schema flattener
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SchemaItem:
    op: str  # u8 u16 u32 u64 varint blob string value
    depth: int
    guarded: bool
    line: int
    arg: Optional[str] = None  # u8 discriminator constant, when a bare ID


_ERRORPATH = object()  # sentinel: this path only error-exits
_OPAQUE_ITEM = SchemaItem(op="<opaque>", depth=0, guarded=False, line=0)

_ENC_PRIM_RE = re.compile(r"^(?:emit|enc)_(u8|u16|u32|u64|varint|blob|string)$")
_DEC_PRIM_RE = re.compile(r"^dec_(u8|u16|u32|u64|varint|blob|string)(?:_obj)?$")
_GUARD_RE = re.compile(r"\w+\s*->\s*pos\s*<\s*\w+\s*->\s*end")
_WT_CONST_RE = re.compile(r"^WT_[A-Z0-9_]+$")
_MSG_CONST_RE = re.compile(r"^_?MSG_[A-Z0-9_]+$")


class _SchemaFlattener:
    def __init__(self, model: "NativeModel", side: str):
        assert side in ("enc", "dec")
        self.model = model
        self.side = side
        self._memo: Dict[str, Optional[List[SchemaItem]]] = {}
        self._stack: Set[str] = set()

    # -- value-codec seeds: atomic `value` ops ----------------------------

    def _is_value_seed(self, fn: CFunc) -> bool:
        toks = fn.body_tokens
        if self.side == "enc":
            # direct emit_u8(_, WT_*|<own param>) call
            for i, t in enumerate(toks):
                if (
                    t.kind == "id"
                    and t.value == "emit_u8"
                    and i + 1 < len(toks)
                    and toks[i + 1].value == "("
                ):
                    args = _call_args(toks, i + 1)
                    if len(args) >= 2:
                        v = _single_id(args[1])
                        if v is not None and (
                            _WT_CONST_RE.match(v) or v in fn.params
                        ):
                            return True
            return False
        # dec side: `case WT_*` labels or WT_* comparisons in the body
        for t in toks:
            if t.kind == "id" and _WT_CONST_RE.match(t.value):
                return True
        return False

    def classify_call(self, name: str) -> Optional[str]:
        """Return an op name for primitive/value calls, 'helper' for
        in-file codec helpers, None for everything else."""
        if self.side == "enc":
            if name in ("emit_value",):
                return "value"
            m = _ENC_PRIM_RE.match(name)
            if m:
                return m.group(1)
            fn = self.model.functions.get(name)
            if fn is not None and name.startswith(("emit_", "enc_", "encode_")):
                if self._is_value_seed(fn):
                    return "value"
                return "helper"
            return None
        if name in ("dec_value",):
            return "value"
        m = _DEC_PRIM_RE.match(name)
        if m:
            return m.group(1)
        fn = self.model.functions.get(name)
        if fn is not None and name.startswith(("dec_", "decode_")):
            if self._is_value_seed(fn):
                return "value"
            return "helper"
        return None

    # -- expression op extraction ----------------------------------------

    def expr_ops(
        self, toks: List[Tok], depth: int, guarded: bool
    ) -> List[SchemaItem]:
        out: List[SchemaItem] = []
        i = 0
        n = len(toks)
        while i < n:
            t = toks[i]
            if t.kind == "id" and i + 1 < n and toks[i + 1].value == "(":
                cls = self.classify_call(t.value)
                if cls is None:
                    i += 1  # descend into args naturally
                    continue
                if cls == "helper":
                    sub = self.flatten_fn(t.value)
                    if sub is None:
                        out.append(_OPAQUE_ITEM)
                    else:
                        for it in sub:
                            out.append(
                                SchemaItem(
                                    op=it.op,
                                    depth=it.depth + depth,
                                    guarded=it.guarded or guarded,
                                    line=t.line,
                                    arg=it.arg,
                                )
                            )
                    i = _skip_call(toks, i + 1)
                    continue
                arg = None
                if cls == "u8":
                    args = _call_args(toks, i + 1)
                    if len(args) >= 2:
                        arg = _single_id(args[1])
                out.append(
                    SchemaItem(
                        op=cls, depth=depth, guarded=guarded, line=t.line, arg=arg
                    )
                )
                i = _skip_call(toks, i + 1)
                continue
            i += 1
        return out


    # -- statement flattening (suffix semantics) -------------------------

    def flatten_fn(self, name: str) -> Optional[List[SchemaItem]]:
        if name in self._memo:
            return self._memo[name]
        if name in self._stack:
            return None  # recursion -> opaque
        fn = self.model.functions.get(name)
        if fn is None or not fn.parsed:
            self._memo[name] = None
            return None
        self._stack.add(name)
        try:
            res = self.flatten_stmts(list(fn.body), 0, False, 0)
        finally:
            self._stack.discard(name)
        if res is _ERRORPATH:
            res = []
        self._memo[name] = res
        return res

    def flatten_stmts(
        self,
        stmts: List[Stmt],
        depth: int,
        guarded: bool,
        rec: int,
    ):
        """Flatten a statement sequence to SchemaItems, or _ERRORPATH if
        every path through it error-exits."""
        if rec > 200:
            return [_OPAQUE_ITEM]
        out: List[SchemaItem] = []
        i = 0
        while i < len(stmts):
            s = stmts[i]
            rest = stmts[i + 1 :]
            if s.kind == "Expr" or s.kind == "Gil":
                out.extend(self.expr_ops(s.tokens, depth, guarded))
                i += 1
                continue
            if s.kind == "Block":
                sub = self.flatten_stmts(
                    list(s.body) + list(rest), depth, guarded, rec + 1
                )
                if sub is _ERRORPATH:
                    return _ERRORPATH
                return out + sub
            if s.kind == "Return":
                if self._is_error_return(s):
                    return _ERRORPATH
                expr = [
                    t
                    for t in s.tokens
                    if not (t.kind == "id" and t.value == "return")
                ]
                out.extend(self.expr_ops(expr, depth, guarded))
                return out
            if s.kind == "Goto":
                return _ERRORPATH  # goto fail idiom
            if s.kind in ("Break", "Continue"):
                return out
            if s.kind == "Label":
                i += 1
                continue
            if s.kind == "If":
                out.extend(self.expr_ops(s.cond, depth, guarded))
                if self._is_guard(s.cond):
                    sub = self.flatten_stmts(list(s.body), depth, True, rec + 1)
                    if sub is _ERRORPATH:
                        out.append(_OPAQUE_ITEM)
                    else:
                        out.extend(sub)
                    if s.orelse:
                        esub = self.flatten_stmts(
                            list(s.orelse), depth, True, rec + 1
                        )
                        if esub is _ERRORPATH or (esub and len(esub) > 0):
                            out.append(_OPAQUE_ITEM)
                    i += 1
                    continue
                t_arm = self.flatten_stmts(
                    list(s.body) + list(rest), depth, guarded, rec + 1
                )
                e_arm = self.flatten_stmts(
                    list(s.orelse) + list(rest), depth, guarded, rec + 1
                )
                if t_arm is _ERRORPATH and e_arm is _ERRORPATH:
                    return _ERRORPATH
                if t_arm is _ERRORPATH:
                    return out + e_arm
                if e_arm is _ERRORPATH:
                    return out + t_arm
                if _items_equal(t_arm, e_arm):
                    return out + t_arm
                return out + [_OPAQUE_ITEM]
            if s.kind == "Loop":
                out.extend(self.expr_ops(s.init, depth, guarded))
                cond_ops = self.expr_ops(s.cond, depth, guarded)
                if cond_ops:
                    # codec ops inside a loop condition: opaque (mirrors
                    # rules_wire's while handling)
                    out.append(_OPAQUE_ITEM)
                    i += 1
                    continue
                sub = self.flatten_stmts(list(s.body), depth + 1, guarded, rec + 1)
                if sub is _ERRORPATH:
                    out.append(_OPAQUE_ITEM)
                else:
                    out.extend(sub)
                out.extend(self.expr_ops(s.step, depth, guarded))
                i += 1
                continue
            if s.kind == "Switch":
                arms = []
                for _labs, body in s.cases:
                    a = self.flatten_stmts(list(body), depth, guarded, rec + 1)
                    if a is not _ERRORPATH:
                        arms.append(a)
                if not arms:
                    i += 1
                    continue
                if all(_items_equal(a, arms[0]) for a in arms[1:]):
                    out.extend(arms[0])
                else:
                    out.append(_OPAQUE_ITEM)
                i += 1
                continue
            i += 1
        return out

    @staticmethod
    def _is_error_return(s: Stmt) -> bool:
        if s.marker in _PY_RETURN_MACROS:
            return False
        vals = [
            t.value
            for t in s.tokens
            if not (t.kind == "id" and t.value == "return")
        ]
        if vals == ["NULL"] or vals == ["-", "1"]:
            return True
        if vals and vals[0] == "PyErr_NoMemory":
            return True
        return False

    @staticmethod
    def _is_guard(cond: List[Tok]) -> bool:
        text = " ".join(t.value for t in cond)
        return bool(_GUARD_RE.search(text))


def _items_equal(a: List[SchemaItem], b: List[SchemaItem]) -> bool:
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if (x.op, x.depth, x.guarded) != (y.op, y.depth, y.guarded):
            return False
    return True


def truncate_opaque(items: List[SchemaItem]) -> Tuple[List[SchemaItem], bool]:
    """Cut the sequence at the first opaque item; returns (items, truncated)."""
    for i, it in enumerate(items):
        if it.op == "<opaque>":
            return items[:i], True
    return items, False


# ---------------------------------------------------------------------------
# dispatcher extraction
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SchemaBranch:
    key: str  # MSG_* constant name (C spelling)
    items: Tuple[SchemaItem, ...]
    truncated: bool
    line: int
    fn_name: str


def encoder_branches(model: "NativeModel") -> Dict[str, SchemaBranch]:
    """Typed encode branches: top-level ifs whose flattened then-arm
    starts with a u8 emission of a MSG_* discriminator."""
    flat = _SchemaFlattener(model, "enc")
    out: Dict[str, SchemaBranch] = {}
    for fn in model.functions.values():
        if not fn.parsed:
            continue
        for s in fn.body:
            if s.kind != "If":
                continue
            seq = flat.flatten_stmts(
                [Stmt("Expr", s.line, tokens=s.cond)] + list(s.body),
                0,
                False,
                0,
            )
            if seq is _ERRORPATH or not seq:
                continue
            first = seq[0]
            if (
                first.op == "u8"
                and first.arg is not None
                and _MSG_CONST_RE.match(first.arg)
            ):
                items, truncated = truncate_opaque(seq[1:])
                out[first.arg] = SchemaBranch(
                    key=first.arg,
                    items=tuple(items),
                    truncated=truncated,
                    line=s.line,
                    fn_name=fn.name,
                )
    return out


def decoder_branches(model: "NativeModel") -> Dict[str, SchemaBranch]:
    """Typed decode branches: switch case-groups labelled case MSG_*."""
    flat = _SchemaFlattener(model, "dec")
    out: Dict[str, SchemaBranch] = {}
    for fn in model.functions.values():
        if not fn.parsed:
            continue
        for sw in _iter_switches(fn.body):
            for labs, body in sw.cases:
                keys = []
                for lab in labs:
                    v = _single_id(lab)
                    if v is not None and _MSG_CONST_RE.match(v):
                        keys.append(v)
                if not keys:
                    continue
                seq = flat.flatten_stmts(list(body), 0, False, 0)
                if seq is _ERRORPATH:
                    continue
                items, truncated = truncate_opaque(seq)
                line = body[0].line if body else sw.line
                for key in keys:
                    out[key] = SchemaBranch(
                        key=key,
                        items=tuple(items),
                        truncated=truncated,
                        line=line,
                        fn_name=fn.name,
                    )
    return out


def _iter_switches(stmts: Sequence[Stmt]):
    for s in stmts:
        if s.kind == "Switch":
            yield s
            for _labs, body in s.cases:
                yield from _iter_switches(body)
        if s.kind in ("Block", "If", "Loop"):
            yield from _iter_switches(s.body)
        if s.kind == "If":
            yield from _iter_switches(s.orelse)


# ---------------------------------------------------------------------------
# the model + per-file entry point
# ---------------------------------------------------------------------------


class NativeModel:
    """All extracted facts for one C/C++ source file."""

    def __init__(self, path: str, source: str):
        self.path = path
        self.source = source
        self.tokens = tokenize(source)
        self.functions: Dict[str, CFunc] = {}
        for fn in extract_functions(self.tokens):
            self.functions.setdefault(fn.name, fn)
        self._consume_cache: Dict[str, Set[str]] = {}

    def may_consume(self, name: str) -> Set[str]:
        """Parameter names the in-file callee may Py_DECREF/CLEAR."""
        cached = self._consume_cache.get(name)
        if cached is not None:
            return cached
        fn = self.functions.get(name)
        out: Set[str] = set()
        if fn is not None:
            toks = fn.body_tokens
            for i, t in enumerate(toks):
                if (
                    t.kind == "id"
                    and t.value in ("Py_DECREF", "Py_XDECREF", "Py_CLEAR")
                    and i + 2 < len(toks)
                    and toks[i + 1].value == "("
                ):
                    args = _call_args(toks, i + 1)
                    if args:
                        v = _single_id(args[0])
                        if v in fn.params:
                            out.add(v)
        self._consume_cache[name] = out
        return out

    def refcount_leaks(self, fn: CFunc) -> List[RefLeak]:
        return _RC(fn, self).run()
