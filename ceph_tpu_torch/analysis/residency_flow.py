"""The residency engine: interprocedural device-residency dataflow.

Port of ``ceph_tpu/analysis/residency_flow.py``, reading PyTorch's
idioms.  The storage path's cost is transfers, not compute: values that
silently ping-pong between host and card are the fault class the
``torch`` pack exists for.  A shallow rule could pattern-match
``.cpu()`` in a loop, but it would be blind to where a tensor actually
LIVES -- it would flag host tensors (noise) and miss card tensors leaking
through a helper call (the real fault).

This module tracks a three-point lattice per value --

    ``device``  -- produced by ``.to(<device>)``, ``.cuda()``,
                   ``torch.*(..., device=<not the CPU>)``,
                   ``residency.device_put``, a kernel wrapper of
                   ``ops/cuda_gf.py`` / ``ops/sweep_gf.py`` or a callee
                   that returns device values; stays device through
                   slicing, arithmetic, ``torch.*`` ops on a device
                   operand and shape-preserving methods;
    ``host``    -- produced by ``np.*``, ``torch.from_numpy``, a
                   ``torch.*`` constructor with no device,
                   ``.cpu()``/``.numpy()``, ``bytes``,
                   ``residency.device_get`` and literals;
    ``unknown`` -- parameters, ``self.*`` attributes, joins of
                   conflicting branches (rules only fire on *definite*
                   device values, so unknown is the safe default)

-- from producers through assignments, returns and direct + ``self.``
method calls (resolved by ``analysis/callgraph.py``'s tables).  Each
function gets a summary:

* ``returns``         -- lattice value of its return expression(s);
* ``syncs``           -- the body performs a definite D2H: an explicit
                         seam call (``residency.device_get``,
                         ``residency.note_d2h``) or an implicit sink
                         (``.cpu()``/``.numpy()``/``.item()``/
                         ``.tolist()``/``np.asarray``/``float()``/
                         iteration) applied to a device value --
                         directly or through a callee;
* ``syncing_params``  -- positions whose argument gets D2H-synced when
                         a device value is passed there (the
                         "transitively-syncing helper" information the
                         resident-section rule needs).

The JAX engine also types a call to a ``jax.jit``-decorated callee as a
device value; PyTorch has no such decorator on the port's paths, so the
callee's own return summary decides.

Summaries reach a module-wide fixpoint so ``self._land()`` three calls
deep still counts as a sync.  Like every cephlint component this is a
pure AST consumer -- nothing under analysis is imported or executed.

Module analyses are memoized on ``(path, source hash)`` -- keyed by
content so a touched-but-unchanged file reuses its summary -- which
keeps repeated scans (``--changed`` then the full gate) from
re-deriving the fixpoint.
"""

from __future__ import annotations

import ast
import hashlib
from typing import Dict, Iterator, List, Optional, Set, Tuple

from ceph_tpu_torch.analysis import callgraph as callgraph_mod
from ceph_tpu_torch.analysis.core import FileContext, call_name, dotted_name

HOST = "host"
DEVICE = "device"
UNKNOWN = "unknown"

#: fixpoint bound (module-wide summary propagation; cycles converge)
_MAX_ROUNDS = 12

#: the kernel wrappers: each launches a hand-written CUDA kernel on its
#: operands' card and returns the result there
KERNEL_WRAPPERS = {
    "matrix_encode_w8", "matrix_encode_w16", "packet_encode",
    "copy_rows", "extract_rows", "pipelined_w8", "int8_4dot", "bf16_4dot",
    "f32_4dot", "bf16_blockdiag", "prec_product", "split_product",
    "extract_fold", "planes_product",
}
_KERNEL_MODULES = ("cuda_gf", "sweep_gf")

#: calls whose result is a device-resident tensor
DEVICE_PRODUCER_CALLS = {
    "residency.device_put", "device_put",
    "accounted_device_matrix", "pipeline.accounted_device_matrix",
} | {f"{m}.{k}" for m in _KERNEL_MODULES for k in KERNEL_WRAPPERS}

#: explicit D2H seams: ALWAYS a transfer, whatever the operand lattice
#: says (these are the sanctioned boundary edges -- legal outside a
#: resident section, a definite violation inside one; the runtime
#: verifier checks the same two seams)
EXPLICIT_D2H_CALLS = {
    "residency.device_get", "residency.note_d2h",
    "device_get", "note_d2h",  # the bare from-import spellings
}

#: implicit D2H sinks: a transfer iff the operand is device-resident
IMPLICIT_SINK_CALLS = {
    "np.asarray", "np.array", "np.ascontiguousarray", "np.frombuffer",
    "numpy.asarray", "numpy.array", "numpy.ascontiguousarray",
    "float", "int", "bool", "bytes", "list", "tuple",
}
#: sinks taking a SEQUENCE whose elements may be device tensors
IMPLICIT_SEQ_SINK_CALLS = {
    "np.stack", "np.concatenate", "numpy.stack", "numpy.concatenate",
}
#: method calls that pull the receiver to host
SINK_METHODS = {"tolist", "item", "cpu", "numpy"}
#: method calls that keep a device receiver on device
DEVICE_PRESERVING_METHODS = {
    "reshape", "view", "contiguous", "clone", "detach", "t", "transpose",
    "permute", "flatten", "ravel", "squeeze", "unsqueeze", "narrow",
    "select", "index_select", "expand", "repeat", "sum", "min", "max",
    "copy_", "fill_", "zero_", "bitwise_xor", "bitwise_and", "bitwise_or",
    "view_as", "chunk", "split", "flip", "roll", "to",
}

#: torch constructors whose tensor lives on the CPU unless ``device=``
#: says otherwise
TORCH_CONSTRUCTORS = {
    "zeros", "ones", "empty", "full", "arange", "eye", "tensor",
    "as_tensor", "from_numpy", "frombuffer", "randint", "rand", "randn",
}
_TORCH_PREFIXES = ("torch.",)

#: host-producing calls (beyond the np prefix probe)
HOST_PRODUCER_CALLS = {
    "bytes", "bytearray", "len", "range", "sorted",
}
_NP_PREFIXES = ("np.", "numpy.")

#: dtype spellings: ``.to(torch.uint8)`` / ``.to(dtype=...)`` keep the
#: receiver where it is
_DTYPE_WORDS = {
    "uint8", "int8", "int16", "int32", "int64", "float16", "bfloat16",
    "float32", "float64", "bool", "long", "int", "float", "double",
    "half", "uint16", "uint32", "uint64", "complex64",
}


def is_cpu_literal(expr: Optional[ast.AST]) -> bool:
    """``"cpu"`` / ``torch.device("cpu")``: a device argument naming the
    host."""
    if isinstance(expr, ast.Constant):
        return isinstance(expr.value, str) and expr.value.startswith("cpu")
    if isinstance(expr, ast.Call) and \
            call_name(expr).rsplit(".", 1)[-1] == "device" and expr.args:
        return is_cpu_literal(expr.args[0])
    return False


def _is_dtype(expr: ast.AST) -> bool:
    name = dotted_name(expr)
    tail = name.rsplit(".", 1)[-1]
    return (name.startswith(("torch.", "np.", "numpy.")) and
            tail in _DTYPE_WORDS) or "dtype" in tail.lower()


def to_target(call: ast.Call) -> Optional[str]:
    """For a ``<x>.to(...)`` call: DEVICE when it moves ``x`` onto a
    device that is not the CPU, HOST when it names the CPU, None when
    it only casts (a dtype, ``copy=``) and so keeps ``x`` where it is."""
    dev = next((kw.value for kw in call.keywords if kw.arg == "device"),
               None)
    if dev is None and call.args and not _is_dtype(call.args[0]):
        dev = call.args[0]
    if dev is None:
        return None
    return HOST if is_cpu_literal(dev) else DEVICE


def device_keyword(call: ast.Call) -> Optional[str]:
    """DEVICE / HOST for a ``device=`` keyword naming a card / the CPU,
    None without one."""
    dev = next((kw.value for kw in call.keywords if kw.arg == "device"),
               None)
    if dev is None:
        return None
    return HOST if is_cpu_literal(dev) else DEVICE


def h2d_operand(call: ast.Call) -> Optional[ast.AST]:
    """The host value an H2D call ships onto a card: the receiver of
    ``x.to(<device>)`` / ``x.cuda()``, the first argument of
    ``residency.device_put(x, dev)`` or ``torch.as_tensor(x,
    device=<card>)``; None for any other call."""
    name = call_name(call)
    if isinstance(call.func, ast.Attribute):
        if call.func.attr == "cuda" or \
                (call.func.attr == "to" and to_target(call) == DEVICE):
            return call.func.value
    if name in ("residency.device_put", "device_put") and call.args:
        return call.args[0]
    if name in ("torch.as_tensor", "torch.tensor") and call.args and \
            device_keyword(call) == DEVICE:
        return call.args[0]
    return None


def join(a: str, b: str) -> str:
    return a if a == b else UNKNOWN


class SyncSite:
    """One D2H transfer site inside a function body."""

    __slots__ = ("node", "kind", "desc", "operand")

    def __init__(self, node: ast.AST, kind: str, desc: str,
                 operand: Optional[ast.AST] = None):
        self.node = node
        #: "explicit" (device_get seam), "implicit" (sink on a device
        #: value), "helper" (call to a syncing callee), "param"
        #: (device argument passed at a callee's syncing position)
        self.kind = kind
        self.desc = desc
        self.operand = operand


class FunctionResidency:
    """Per-function residency facts + the interprocedural summary."""

    __slots__ = ("info", "names", "returns", "syncs", "sync_desc",
                 "syncing_params", "sync_sites", "param_names", "own")

    def __init__(self, info):
        self.info = info  # callgraph.FunctionInfo
        self.names: Dict[str, str] = {}
        self.returns = UNKNOWN
        self.syncs = False
        self.sync_desc = ""
        self.syncing_params: Set[int] = set()
        self.sync_sites: List[SyncSite] = []
        args = info.node.args
        params = [a.arg for a in getattr(args, "posonlyargs", [])] + \
                 [a.arg for a in args.args]
        if params and params[0] in ("self", "cls"):
            params = params[1:]
        self.param_names: List[str] = params
        #: the body's own statements and expressions (nested defs
        #: excluded), listed once: the fixpoint re-reads them each round
        self.own: List[ast.AST] = list(
            ModuleResidency._own_stmts_and_exprs(info.node))


class ModuleResidency:
    """Residency lattice + summaries for every function in one module."""

    def __init__(self, ctx: FileContext):
        self.ctx = ctx
        self.graph = callgraph_mod.get(ctx)
        #: qualname -> FunctionResidency
        self.functions: Dict[str, FunctionResidency] = {
            q: FunctionResidency(info)
            for q, info in self.graph.functions.items()
        }
        self._fixpoint()

    # -- interprocedural fixpoint ------------------------------------------

    def _fixpoint(self) -> None:
        for _ in range(_MAX_ROUNDS):
            changed = False
            for fr in self.functions.values():
                before = (fr.returns, fr.syncs,
                          frozenset(fr.syncing_params))
                self._analyze(fr)
                if (fr.returns, fr.syncs,
                        frozenset(fr.syncing_params)) != before:
                    changed = True
            if not changed:
                break

    # -- queries -----------------------------------------------------------

    def of_node(self, node: ast.AST) -> Optional[FunctionResidency]:
        info = self.graph.by_node.get(node)
        if info is None:
            return None
        return self.functions.get(info.qualname)

    def resolve_call(self, fr: FunctionResidency,
                     call: ast.Call) -> Optional[FunctionResidency]:
        qual = self.graph._resolve_call(fr.info, call)
        if qual is None:
            return None
        return self.functions.get(qual)

    # -- per-function analysis ---------------------------------------------

    def _analyze(self, fr: FunctionResidency) -> None:
        """(Re)compute one function's lattice, sink sites and summary
        given the current callee summaries.  Flow-insensitive over the
        body (two passes settle forward+backward name references)."""
        fr.sync_sites = []
        fr.syncs = False
        fr.sync_desc = ""
        fr.syncing_params = set()
        for _ in range(2):
            for node in fr.own:
                if isinstance(node, ast.Assign):
                    res = self.expr_res(fr, node.value)
                    for tgt in node.targets:
                        self._bind(fr, tgt, res)
                elif isinstance(node, ast.AnnAssign) and node.value:
                    self._bind(fr, node.target,
                               self.expr_res(fr, node.value))
                elif isinstance(node, ast.AugAssign):
                    if isinstance(node.target, ast.Name):
                        res = join(
                            fr.names.get(node.target.id, UNKNOWN),
                            self.expr_res(fr, node.value))
                        fr.names[node.target.id] = res
                elif isinstance(node, (ast.For, ast.AsyncFor)):
                    # iterating a device array: each element stays a
                    # device scalar/row (and the loop is a sink, see
                    # below)
                    res = self.expr_res(fr, node.iter)
                    self._bind(fr, node.target,
                               DEVICE if res == DEVICE else UNKNOWN)
        # final pass: collect sink sites + returns with settled names
        returns: List[str] = []
        for node in fr.own:
            if isinstance(node, ast.Return) and node.value is not None:
                returns.append(self.expr_res(fr, node.value))
            self._collect_sinks(fr, node)
        fr.returns = returns[0] if returns else UNKNOWN
        for r in returns[1:]:
            fr.returns = join(fr.returns, r)
        # summary: any definite sink makes the function syncing
        for site in fr.sync_sites:
            if not fr.syncs:
                fr.syncs = True
                fr.sync_desc = site.desc
            # a sink whose operand is a bare (never locally re-bound to
            # host) parameter marks that position syncing
            op = site.operand
            if isinstance(op, ast.Name) and op.id in fr.param_names and \
                    fr.names.get(op.id, UNKNOWN) != HOST:
                fr.syncing_params.add(fr.param_names.index(op.id))

    def _bind(self, fr: FunctionResidency, target: ast.expr,
              res: str) -> None:
        if isinstance(target, ast.Name):
            fr.names[target.id] = res
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._bind(fr, elt, UNKNOWN)

    @staticmethod
    def _own_stmts_and_exprs(fn: ast.AST) -> Iterator[ast.AST]:
        stack: List[ast.AST] = list(ast.iter_child_nodes(fn))
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                continue
            yield node
            stack.extend(ast.iter_child_nodes(node))

    # -- expression lattice -------------------------------------------------

    def expr_res(self, fr: FunctionResidency, e: ast.AST,
                 depth: int = 0) -> str:
        if depth > 24:
            return UNKNOWN
        if isinstance(e, ast.Name):
            return fr.names.get(e.id, UNKNOWN)
        if isinstance(e, ast.Constant):
            return HOST
        if isinstance(e, ast.Call):
            return self._call_res(fr, e, depth)
        if isinstance(e, ast.Subscript):
            # slicing/indexing a device array yields a device array
            base = self.expr_res(fr, e.value, depth + 1)
            return DEVICE if base == DEVICE else UNKNOWN
        if isinstance(e, (ast.BinOp,)):
            left = self.expr_res(fr, e.left, depth + 1)
            right = self.expr_res(fr, e.right, depth + 1)
            if DEVICE in (left, right):
                return DEVICE  # device op promotes the result to device
            if left == right == HOST:
                return HOST
            return UNKNOWN
        if isinstance(e, ast.UnaryOp):
            return self.expr_res(fr, e.operand, depth + 1)
        if isinstance(e, ast.IfExp):
            return join(self.expr_res(fr, e.body, depth + 1),
                        self.expr_res(fr, e.orelse, depth + 1))
        if isinstance(e, ast.Attribute):
            # x.T / x.at on a device value stays device; anything else
            # (self.foo, module attrs) is unknown
            if e.attr in ("T", "mT", "real") and \
                    self.expr_res(fr, e.value, depth + 1) == DEVICE:
                return DEVICE
            return UNKNOWN
        if isinstance(e, ast.Await):
            return self.expr_res(fr, e.value, depth + 1)
        return UNKNOWN

    def _call_res(self, fr: FunctionResidency, call: ast.Call,
                  depth: int) -> str:
        name = call_name(call)
        if name in DEVICE_PRODUCER_CALLS:
            return DEVICE
        if name in EXPLICIT_D2H_CALLS or name in HOST_PRODUCER_CALLS or \
                name.startswith(_NP_PREFIXES) or \
                name in IMPLICIT_SINK_CALLS or \
                name in IMPLICIT_SEQ_SINK_CALLS:
            return HOST
        if name.startswith(_TORCH_PREFIXES):
            where = device_keyword(call)
            if where is not None:
                return where
            tail = name.rsplit(".", 1)[-1]
            if tail in TORCH_CONSTRUCTORS:
                return HOST
            if tail.endswith("_like") and call.args:
                return self.expr_res(fr, call.args[0], depth + 1)
            # any other torch op runs where its operands live
            if any(self.expr_res(fr, a, depth + 1) == DEVICE
                   for a in call.args):
                return DEVICE
            return UNKNOWN
        # method call: residency-preserving ops keep the receiver's home
        if isinstance(call.func, ast.Attribute):
            attr = call.func.attr
            if attr in SINK_METHODS:
                return HOST
            if attr == "cuda":
                return DEVICE
            if attr == "to":
                target = to_target(call)
                if target is not None:
                    return target
            recv = self.expr_res(fr, call.func.value, depth + 1)
            if attr in DEVICE_PRESERVING_METHODS and recv == DEVICE:
                return DEVICE
        callee = self.resolve_call(fr, call)
        if callee is not None:
            return callee.returns
        return UNKNOWN

    # -- sink collection ----------------------------------------------------

    def _collect_sinks(self, fr: FunctionResidency, node: ast.AST) -> None:
        if isinstance(node, (ast.For, ast.AsyncFor)):
            if self.expr_res(fr, node.iter) == DEVICE:
                fr.sync_sites.append(SyncSite(
                    node, "implicit",
                    "Python iteration over a device array (one blocking "
                    "D2H per element)",
                    node.iter))
            return
        if not isinstance(node, ast.Call):
            return
        name = call_name(node)
        operand = node.args[0] if node.args else None
        if name in EXPLICIT_D2H_CALLS:
            fr.sync_sites.append(SyncSite(
                node, "explicit", f"{name}(...) is an explicit D2H edge",
                operand))
            return
        if name in IMPLICIT_SINK_CALLS and operand is not None:
            res = self.expr_res(fr, operand)
            if res == DEVICE:
                fr.sync_sites.append(SyncSite(
                    node, "implicit",
                    f"{name}(...) on a device-resident value pulls it "
                    "to host", operand))
            elif isinstance(operand, ast.Name) and \
                    operand.id in fr.param_names and res != HOST:
                # sink on a parameter of unknown residency: the
                # function syncs WHATEVER it is handed -- callers
                # passing a device value get flagged at the call site
                fr.syncing_params.add(fr.param_names.index(operand.id))
            return
        if name in IMPLICIT_SEQ_SINK_CALLS and operand is not None:
            elts = operand.elts if isinstance(
                operand, (ast.List, ast.Tuple)) else [operand]
            for elt in elts:
                # a comprehension over a device array D2Hs every element
                if isinstance(elt, (ast.ListComp, ast.GeneratorExp)) and \
                        any(self.expr_res(fr, gen.iter) == DEVICE
                            for gen in elt.generators):
                    fr.sync_sites.append(SyncSite(
                        node, "implicit",
                        f"{name}(...) gathers elements of a device "
                        "array to host", elt))
                    return
                if self.expr_res(fr, elt) == DEVICE:
                    fr.sync_sites.append(SyncSite(
                        node, "implicit",
                        f"{name}(...) on device-resident value(s) pulls "
                        "them to host", elt))
                    return
            return
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr == "to" and to_target(node) == HOST:
            recv = node.func.value
            if self.expr_res(fr, recv) == DEVICE:
                fr.sync_sites.append(SyncSite(
                    node, "implicit",
                    ".to(<the CPU>) on a device-resident value pulls it "
                    "to host", recv))
            return
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr == "copy_" and node.args and \
                self.expr_res(fr, node.func.value) == HOST and \
                self.expr_res(fr, node.args[0]) == DEVICE:
            fr.sync_sites.append(SyncSite(
                node, "implicit",
                ".copy_() of a device-resident value into a host tensor "
                "pulls it to host", node.args[0]))
            return
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in SINK_METHODS:
            recv = node.func.value
            res = self.expr_res(fr, recv)
            if res == DEVICE:
                fr.sync_sites.append(SyncSite(
                    node, "implicit",
                    f".{node.func.attr}() on a device-resident value "
                    "pulls it to host", recv))
            elif isinstance(recv, ast.Name) and \
                    recv.id in fr.param_names and res != HOST:
                fr.syncing_params.add(fr.param_names.index(recv.id))
            return
        # interprocedural: a call to a syncing module-local helper, or a
        # device argument handed to a callee position that syncs it
        callee = self.resolve_call(fr, node)
        if callee is None or callee is fr:
            return
        if callee.syncs:
            fr.sync_sites.append(SyncSite(
                node, "helper",
                f"{name}() syncs to host inside its body "
                f"({callee.sync_desc})", None))
            return
        if callee.syncing_params:
            for idx, arg in enumerate(node.args):
                if idx in callee.syncing_params and \
                        self.expr_res(fr, arg) == DEVICE:
                    fr.sync_sites.append(SyncSite(
                        node, "param",
                        f"{name}() D2H-syncs its argument "
                        f"{callee.param_names[idx]!r} and this call "
                        "passes a device-resident value there", arg))
                    return


# -- memoization ------------------------------------------------------------

#: path -> (source blake2 digest, ModuleResidency); content-keyed so a
#: rescan of an unchanged file (``--changed`` then the full gate, bench)
#: reuses the fixpoint instead of re-deriving it
_CACHE: Dict[str, Tuple[bytes, ModuleResidency]] = {}
_CACHE_MAX = 512


def get(ctx: FileContext) -> ModuleResidency:
    digest = hashlib.blake2b(ctx.source.encode("utf-8", "replace"),
                             digest_size=16).digest()
    hit = _CACHE.get(ctx.path)
    if hit is not None and hit[0] == digest:
        return hit[1]
    analysis = ModuleResidency(ctx)
    if len(_CACHE) >= _CACHE_MAX:
        _CACHE.clear()
    _CACHE[ctx.path] = (digest, analysis)
    return analysis
