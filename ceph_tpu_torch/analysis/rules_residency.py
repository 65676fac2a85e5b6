"""Device-residency invariants for the storage hot path (the ``torch``
pack's flow rules).

Port of ``ceph_tpu/analysis/rules_residency.py``: the five ``jax-*``
rules there become ``torch-*`` rules that read the port's PyTorch
idioms (``rules_torch.py`` maps each one).  All ride the
interprocedural lattice in ``analysis/residency_flow.py``:

* ``torch-d2h-in-resident-section`` -- a D2H transfer (explicit
  ``residency.device_get`` / ``note_d2h`` seam, ``.cpu()`` /
  ``.numpy()`` / ``.item()`` / ``.tolist()`` / ``np.asarray`` /
  ``float()`` on a device value, iteration, or a call to a helper that
  transitively syncs) is reachable inside a declared ``# cephlint:
  device-resident-section <name>`` region.  The declaration is the
  storage path's transfer contract: inside the region bytes stay on the
  card.  The same regions are enforced at runtime by
  ``analysis/residency.py`` (its counted D2H seams raise inside an open
  section), so each section must also carry its
  ``resident_section(<name>)`` runtime guard.
* ``torch-recompile-hazard`` -- setup work that must not recur on a hot
  path, reachable per call: ``torch.compile`` / ``torch.jit.script`` /
  ``torch.jit.trace`` / ``triton.jit`` constructed inside a function
  body, or a kernel-library build or load (``ctypes.CDLL``,
  ``torch.utils.cpp_extension.load``/``load_inline``, a
  ``residency.note_library_build()`` site) outside a cache-miss guard
  (``if lib is None:``, a ``not in`` probe, an ``lru_cache``d builder,
  or a helper that the module calls only from such places).
  The JAX rule's other two arms -- a shape-derived value fed raw to a
  ``static_argnums`` parameter and a weak-typed scalar literal fed to a
  traced one -- have no PyTorch counterpart: the port's kernels take
  sizes and scalars as launch arguments and build once per source.
* ``torch-donated-after-use`` -- the PyTorch role of donation: a buffer
  handed to an asynchronous copy (``dst.copy_(src, non_blocking=True)``,
  ``src.to(<card>, non_blocking=True)``) belongs to the copy engine
  until a synchronize (``event.synchronize()``, ``stream.synchronize()``,
  ``torch.cuda.synchronize()``).  Reading the destination's bytes (or
  writing the source's) on a CFG path before one sees half-copied
  memory.
* ``torch-loop-invariant-transfer`` -- H2D (``.to(<card>)``,
  ``.cuda()``, ``residency.device_put``, ``torch.as_tensor(...,
  device=)``) of a loop-invariant value inside a loop, a D2H of a
  loop-invariant device value per iteration (Python iteration over a
  device tensor included), and the method-scope variant: per-call
  upload of instance-constant state (``self.B.to(dev)`` outside
  ``__init__``).  Hoist onto the accounted upload cache
  (``ops/pipeline.py accounted_device_matrix``) or upload once at
  construction.
* ``torch-percall-sharding-construction`` -- a placement object (the
  port's ``Mesh`` / ``make_mesh`` / ``Placement``, ``DeviceMesh`` /
  ``init_device_mesh``, a ``torch.cuda.Stream`` / ``new_stream``,
  ``torch.distributed.new_group``) constructed inside a loop or inside a
  compiled function: placement is dispatch-invariant -- build once and
  cache (the mesh plane's ``sharding()`` / ``collective_mesh()``).  A
  loop in a constructor (one stream per mesh cell, built with the mesh)
  is the cache itself.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple

from ceph_tpu_torch.analysis import cfg as cfg_mod
from ceph_tpu_torch.analysis import residency_flow as flow
from ceph_tpu_torch.analysis.core import (SEV_ERROR, SEV_WARNING,
                                          FileContext, Finding, call_name,
                                          decorator_names,
                                          parse_resident_sections, rule)


def _in_port(ctx: FileContext) -> bool:
    return ctx.path.startswith("ceph_tpu_torch/")


def _compiled(fn_node: ast.AST) -> bool:
    """Decorated with ``torch.compile`` / ``torch.jit.script`` /
    ``triton.jit`` (a traced or generated body)."""
    return any(d.rsplit(".", 1)[-1] in ("compile", "script", "jit")
               for d in decorator_names(fn_node))


# -- rule: D2H inside a declared device-resident section --------------------


@rule(
    "torch-d2h-in-resident-section", "torch", SEV_ERROR,
    "a D2H transfer (.cpu() / .numpy() / .item() / .tolist() / "
    "np.asarray / float() / iteration / device_get / note_d2h, or a "
    "helper that transitively syncs) is reachable inside a declared "
    "`cephlint: device-resident-section` region, or the markers are "
    "malformed / missing their runtime resident_section() guard.  The "
    "region declares that bytes stay in card memory; the runtime "
    "verifier (analysis/residency.py) enforces the same contract on its "
    "counted D2H seams",
)
def check_d2h_in_resident_section(ctx: FileContext) -> Iterator[Finding]:
    if "device-resident-section" not in ctx.source:
        return
    sections, problems = parse_resident_sections(ctx.lines)
    for line, message in problems:
        yield Finding("torch-d2h-in-resident-section", ctx.path, line, 0,
                      message, SEV_ERROR)
    if not sections:
        return
    analysis = flow.get(ctx)
    # each declared region must pair with its runtime guard: a
    # resident_section("<name>") call between the markers (the static
    # markers and the transfer_guard scope must cover the same lines)
    guarded: Set[str] = set()
    for node in analysis.ctx.walk():
        if isinstance(node, ast.Call) and \
                call_name(node).rsplit(".", 1)[-1] == "resident_section" \
                and node.args and isinstance(node.args[0], ast.Constant):
            for s in sections:
                if s.start < node.lineno < s.end and \
                        node.args[0].value == s.name:
                    guarded.add(s.name)
    for s in sections:
        if s.name not in guarded:
            yield Finding(
                "torch-d2h-in-resident-section", ctx.path, s.start, 0,
                f"device-resident-section {s.name!r} has no matching "
                f"runtime guard: wrap the region's body in "
                f"`with resident_section({s.name!r}):` "
                "(ceph_tpu_torch.analysis.residency) so the declaration is "
                "enforced, not trusted", SEV_ERROR)
    for fr in analysis.functions.values():
        for site in fr.sync_sites:
            line = getattr(site.node, "lineno", None)
            if line is None:
                continue
            section = next(
                (s for s in sections if s.start < line < s.end), None)
            if section is None:
                continue
            yield ctx.finding(
                "torch-d2h-in-resident-section", site.node,
                f"D2H transfer inside device-resident-section "
                f"{section.name!r} (lines {section.start}-{section.end}):"
                f" {site.desc}; the section declares this stretch "
                "device-resident -- move the sync to the section "
                "boundary or keep the value on device",
            )


# -- rule: per-call compile / library build --------------------------------

#: compile entry points: each call builds a fresh compiled callable
_COMPILE_CALLS = {
    "torch.compile", "torch.jit.script", "torch.jit.trace", "triton.jit",
    "jit.script", "jit.trace",
}
#: kernel-library builds and loads
_LIBRARY_CALLS = {
    "ctypes.CDLL", "ctypes.cdll.LoadLibrary", "CDLL",
    "cpp_extension.load", "cpp_extension.load_inline",
    "torch.utils.cpp_extension.load", "torch.utils.cpp_extension.load_inline",
    "load_inline", "residency.note_library_build", "note_library_build",
}
#: decorators that make a builder run once per key
_CACHE_DECORATORS = ("lru_cache", "cache", "cached_property")


def _guards_cache_miss(test: ast.AST) -> bool:
    """The branch runs only on a cache miss: ``x is None``, ``not x``,
    ``k not in cache``."""
    for node in ast.walk(test):
        if isinstance(node, ast.Compare) and any(
                isinstance(op, (ast.Is, ast.NotIn)) for op in node.ops):
            if any(isinstance(c, ast.Constant) and c.value is None
                   for c in node.comparators) or \
                    any(isinstance(op, ast.NotIn) for op in node.ops):
                return True
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
            return True
    return False


def _site_once(node: ast.AST, parents, once: Set[str]) -> bool:
    """The call at ``node`` runs once per process and key: under a
    cache-miss branch, at module level, or inside a function that is
    itself once (see :func:`_once_functions`)."""
    cur = node
    while cur in parents:
        parent = parents[cur]
        if isinstance(parent, ast.If) and \
                any(cur is b for b in parent.body) and \
                _guards_cache_miss(parent.test):
            return True
        if isinstance(parent, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return parent.name in once
        cur = parent
    return True  # module level: runs once at import


def _once_functions(ctx: FileContext) -> Set[str]:
    """Names of the module's functions that run once per process and
    key: cached builders (``lru_cache``), and functions every one of
    whose call sites in the module is itself once (``lib()`` calling
    ``_load()`` under ``if _lib is None:``; a probe's ``main()`` called
    from the ``__main__`` block).  A function nothing in the module calls
    is an entry point: its callers may loop, so it is not once."""
    parents = ctx.parent_map()
    fns: Dict[str, List[ast.AST]] = {}
    sites: Dict[str, List[ast.AST]] = {}
    for node in ctx.walk():
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fns.setdefault(node.name, []).append(node)
        elif isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Name):
                sites.setdefault(f.id, []).append(node)
            elif isinstance(f, ast.Attribute) and \
                    isinstance(f.value, ast.Name) and \
                    f.value.id in ("self", "cls"):
                sites.setdefault(f.attr, []).append(node)
    once: Set[str] = {
        name for name, nodes in fns.items()
        if all(any(d.rsplit(".", 1)[-1] in _CACHE_DECORATORS
                   for d in decorator_names(n)) for n in nodes)}
    changed = True
    while changed:
        changed = False
        for name in fns:
            if name in once or not sites.get(name):
                continue
            if all(_site_once(site, parents, once - {name})
                   for site in sites[name]):
                once.add(name)
                changed = True
    return once


@rule(
    "torch-recompile-hazard", "torch", SEV_WARNING,
    "setup work reachable per call: torch.compile / torch.jit.script / "
    "triton.jit constructed inside a function body (a fresh compiled "
    "callable, an empty compile cache, every call), or a kernel-library "
    "build or load (ctypes.CDLL, cpp_extension.load, a "
    "note_library_build() site) outside a cache-miss guard -- build once "
    "per process and key (the `if lib is None:` cache of ops/cuda_gf.py "
    "load())",
)
def check_recompile_hazard(ctx: FileContext) -> Iterator[Finding]:
    if not _in_port(ctx) or not ctx.imports_module("torch", "ctypes"):
        return
    parents = ctx.parent_map()

    def _in_decorator(node: ast.AST) -> bool:
        cur = node
        while cur in parents:
            parent = parents[cur]
            decs = getattr(parent, "decorator_list", [])
            if any(cur is d for d in decs):
                return True
            cur = parent
        return False

    once: Optional[Set[str]] = None
    for node in ctx.walk():
        if not isinstance(node, ast.Call):
            continue
        name = call_name(node)
        is_compile = name in _COMPILE_CALLS
        is_library = name in _LIBRARY_CALLS
        if not (is_compile or is_library) or _in_decorator(node):
            continue
        fn = None
        cur = node
        while cur in parents:
            cur = parents[cur]
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fn = cur
                break
        if fn is None:
            continue  # module level: runs once at import
        if is_compile:
            stmt = node
            while stmt in parents and not isinstance(stmt, ast.stmt):
                stmt = parents[stmt]
            # sanctioned caching shapes: `return torch.compile(f)` from a
            # builder (the caller caches the result) and
            # `self._fn = torch.compile(f)`
            if isinstance(stmt, ast.Return):
                continue
            if isinstance(stmt, ast.Assign) and any(
                    isinstance(t, ast.Attribute) for t in stmt.targets):
                continue
            yield ctx.finding(
                "torch-recompile-hazard", node,
                f"{name}(...) constructed inside a function body: every "
                "call builds a fresh compiled callable with an empty "
                "compile cache; build it once (module level, __init__, "
                "or a cached builder)",
            )
            continue
        if once is None:
            once = _once_functions(ctx)
        if not _site_once(node, parents, once):
            yield ctx.finding(
                "torch-recompile-hazard", node,
                f"{name}(...) outside a cache-miss guard: the library is "
                "built or loaded on every call of "
                f"{fn.name}(); keep it behind `if lib is None:` (or a "
                "keyed cache) so it happens once per process",
            )


# -- CFG helpers ------------------------------------------------------------


def _stmt_of(node: ast.AST, parents) -> Optional[ast.stmt]:
    cur = node
    while cur in parents and not isinstance(cur, ast.stmt):
        cur = parents[cur]
    return cur if isinstance(cur, ast.stmt) else None


def _own_exprs(stmt: ast.stmt) -> Iterator[ast.AST]:
    for child in ast.iter_child_nodes(stmt):
        if isinstance(child, ast.stmt):
            continue
        for node in ast.walk(child):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                continue
            yield node


def _rebinds_name(stmt: ast.stmt, name: str) -> bool:
    targets: List[ast.expr] = []
    if isinstance(stmt, ast.Assign):
        targets = stmt.targets
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        targets = [stmt.target]
    elif isinstance(stmt, (ast.For, ast.AsyncFor)):
        targets = [stmt.target]
    for t in targets:
        for n in ast.walk(t):
            if isinstance(n, ast.Name) and n.id == name:
                return True
    return False


# -- rule: buffer touched while an asynchronous copy owns it ---------------


def _is_async_copy(call: ast.Call) -> Optional[Tuple[str, ast.AST]]:
    """``("dst", node)`` for ``dst.copy_(src, non_blocking=True)`` (the
    destination fills asynchronously), ``("src", node)`` for
    ``src.to(<card>, non_blocking=True)`` / ``dst.copy_(src,
    non_blocking=True)`` (the source is read asynchronously)."""
    if not isinstance(call.func, ast.Attribute):
        return None
    if not any(kw.arg == "non_blocking" and
               isinstance(kw.value, ast.Constant) and kw.value.value
               for kw in call.keywords):
        return None
    return (call.func.attr, call.func.value) \
        if call.func.attr in ("copy_", "to") else None


#: methods that read a tensor's bytes on the host
_CONTENT_READS = {"numpy", "tolist", "item", "tobytes", "clone", "cpu",
                  "sum", "__getitem__", "equal", "any", "all"}


def _touches(stmt: ast.stmt, name: str, mode: str) -> bool:
    """``mode="read"``: the statement reads ``name``'s bytes (a
    subscript load, a content method, a numpy/bytes conversion,
    iteration); ``mode="write"``: it writes them (a subscript store, an
    in-place ``*_`` method)."""
    for node in _own_exprs(stmt):
        if mode == "read":
            if isinstance(node, ast.Subscript) and \
                    isinstance(node.value, ast.Name) and \
                    node.value.id == name and \
                    isinstance(node.ctx, ast.Load):
                return True
            if isinstance(node, ast.Call):
                f = node.func
                if isinstance(f, ast.Attribute) and \
                        isinstance(f.value, ast.Name) and \
                        f.value.id == name and f.attr in _CONTENT_READS:
                    return True
                cname = call_name(node)
                if (cname.startswith(("np.", "numpy.")) or
                        cname in ("bytes", "bytearray", "memoryview",
                                  "list", "tuple")) and \
                        any(isinstance(a, ast.Name) and a.id == name
                            for a in node.args):
                    return True
        else:
            if isinstance(node, ast.Subscript) and \
                    isinstance(node.value, ast.Name) and \
                    node.value.id == name and \
                    isinstance(node.ctx, ast.Store):
                return True
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    isinstance(node.func.value, ast.Name) and \
                    node.func.value.id == name and \
                    node.func.attr.endswith("_") and \
                    not node.func.attr.startswith("_"):
                return True
    if mode == "read" and isinstance(stmt, (ast.For, ast.AsyncFor)) and \
            isinstance(stmt.iter, ast.Name) and stmt.iter.id == name:
        return True
    return False


def _synchronizes(stmt: ast.stmt) -> bool:
    """The statement blocks the host on queued card work: any
    ``synchronize()`` (event, stream, ``torch.cuda``).  A
    ``wait_event``/``wait_stream`` orders streams only, so it does not
    count for host reads and writes."""
    return any(isinstance(n, ast.Call) and
               call_name(n).rsplit(".", 1)[-1] == "synchronize"
               for n in _own_exprs(stmt))


@rule(
    "torch-donated-after-use", "torch", SEV_ERROR,
    "a buffer handed to an asynchronous copy (dst.copy_(src, "
    "non_blocking=True) or src.to(<card>, non_blocking=True)) is touched "
    "on a CFG path before any synchronize(): the destination's bytes are "
    "read before they have landed, or the source's overwritten before "
    "they have left -- the copy engine owns the buffer until the "
    "event/stream is synchronized (the PyTorch role of JAX's donation)",
)
def check_donated_after_use(ctx: FileContext) -> Iterator[Finding]:
    if not ctx.imports_module("torch") or "non_blocking" not in ctx.source:
        return
    analysis = flow.get(ctx)
    parents = analysis.ctx.parent_map()
    cfg_cache: Dict[int, cfg_mod.CFG] = {}
    for fr in analysis.functions.values():
        for node in fr.own:
            if not isinstance(node, ast.Call):
                continue
            kind = _is_async_copy(node)
            if kind is None:
                continue
            attr, recv = kind
            owned: List[Tuple[str, str]] = []  # (name, "read"/"write")
            if attr == "copy_":
                if isinstance(recv, ast.Name):
                    owned.append((recv.id, "read"))
                if node.args and isinstance(node.args[0], ast.Name):
                    owned.append((node.args[0].id, "write"))
            elif isinstance(recv, ast.Name) and \
                    flow.to_target(node) == flow.DEVICE:
                owned.append((recv.id, "write"))
            if not owned:
                continue
            fcfg = cfg_cache.get(id(fr.info.node))
            if fcfg is None:
                fcfg = cfg_mod.build(fr.info.node)
                cfg_cache[id(fr.info.node)] = fcfg
            call_stmt = _stmt_of(node, parents)
            if call_stmt is None or call_stmt not in fcfg.succ:
                continue
            for name, mode in owned:
                hit = _first_touch_before_sync(fcfg, call_stmt, name, mode)
                if hit is not None:
                    what = ("read" if mode == "read" else "written")
                    yield ctx.finding(
                        "torch-donated-after-use", hit,
                        f"{name!r} is owned by the asynchronous copy on "
                        f"line {node.lineno} and is {what} here before "
                        "any synchronize(): synchronize its event (or "
                        "the stream) first",
                    )


def _first_touch_before_sync(fcfg: cfg_mod.CFG, src: ast.stmt, name: str,
                             mode: str) -> Optional[ast.stmt]:
    """First CFG-reachable statement touching ``name`` in ``mode`` with
    no synchronize and no rebind of ``name`` on the path."""
    seen: Set[int] = set()
    frontier: List[object] = list(fcfg.succ.get(src, []))
    while frontier:
        node = frontier.pop()
        if node is cfg_mod.EXIT or id(node) in seen or node is src:
            continue
        seen.add(id(node))
        if _synchronizes(node):  # type: ignore[arg-type]
            continue
        if _touches(node, name, mode):  # type: ignore[arg-type]
            return node  # type: ignore[return-value]
        if _rebinds_name(node, name):  # type: ignore[arg-type]
            continue
        frontier.extend(fcfg.succ.get(node, []))
    return None


# -- rule: loop-invariant transfers -----------------------------------------


def _assigned_names(stmts: List[ast.stmt]) -> Tuple[Set[str], Set[str]]:
    """(names, self-attrs) stored anywhere under ``stmts``."""
    names: Set[str] = set()
    attrs: Set[str] = set()
    stack: List[ast.AST] = list(stmts)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        if isinstance(node, (ast.Name,)) and isinstance(node.ctx,
                                                        ast.Store):
            names.add(node.id)
        if isinstance(node, ast.Attribute) and \
                isinstance(node.ctx, ast.Store) and \
                isinstance(node.value, ast.Name) and \
                node.value.id == "self":
            attrs.add(node.attr)
        stack.extend(ast.iter_child_nodes(node))
    return names, attrs


def _invariant_operand(expr: ast.AST, loop_names: Set[str],
                       loop_attrs: Set[str]) -> Optional[str]:
    """Spelling of ``expr`` when it provably does not change across loop
    iterations: a Name never stored in the loop, or a self.<attr> never
    stored in the loop."""
    if isinstance(expr, ast.Name) and expr.id not in loop_names:
        return expr.id
    if isinstance(expr, ast.Attribute) and \
            isinstance(expr.value, ast.Name) and \
            expr.value.id == "self" and expr.attr not in loop_attrs:
        return f"self.{expr.attr}"
    return None


@rule(
    "torch-loop-invariant-transfer", "torch", SEV_WARNING,
    "an H2D upload (.to(<card>) / .cuda() / device_put / "
    "torch.as_tensor(..., device=)) or D2H pull of a value that does not "
    "change across iterations sits inside a loop (or a per-call upload "
    "of instance-constant state like self.B.to(dev) outside __init__): "
    "the same bytes cross the bus every pass.  Hoist it out, or route "
    "codec matrices through the accounted upload cache (ops/pipeline.py "
    "accounted_device_matrix)",
)
def check_loop_invariant_transfer(ctx: FileContext) -> Iterator[Finding]:
    if not _in_port(ctx) or not ctx.imports_module("torch"):
        return
    analysis = flow.get(ctx)
    reported: Set[Tuple[int, int]] = set()

    def _once(node: ast.AST) -> bool:
        mark = (getattr(node, "lineno", 0), getattr(node, "col_offset", 0))
        if mark in reported:
            return False
        reported.add(mark)
        return True

    for fr in analysis.functions.values():
        fn_node = fr.info.node
        # iteration over a device tensor: per-element D2H of a value the
        # loop itself does not change
        for node in fr.own:
            if isinstance(node, (ast.For, ast.AsyncFor)) and \
                    analysis.expr_res(fr, node.iter) == flow.DEVICE \
                    and _once(node):
                yield ctx.finding(
                    "torch-loop-invariant-transfer", node,
                    "Python for-loop iterates a device tensor element-"
                    "wise: every element is a separate blocking D2H; "
                    "pull it to host once (device_get) outside the "
                    "loop or vectorize the body",
                )
        # per-call upload of instance state (no loop needed: the caller
        # IS the loop)
        if fn_node.name not in ("__init__", "__post_init__", "__new__"):
            for node in fr.own:
                if not isinstance(node, ast.Call):
                    continue
                op = flow.h2d_operand(node)
                if isinstance(op, ast.Attribute) and \
                        isinstance(op.value, ast.Name) and \
                        op.value.id == "self" and _once(node):
                    yield ctx.finding(
                        "torch-loop-invariant-transfer", node,
                        f"per-call H2D of instance state "
                        f"self.{op.attr}: every call re-ships the "
                        "same bytes; upload once in __init__ or "
                        "route through accounted_device_matrix "
                        "(ops/pipeline.py)",
                    )
        # lexical loops: invariant H2D / invariant-device D2H inside
        for loop in fr.own:
            if not isinstance(loop, (ast.For, ast.AsyncFor, ast.While)):
                continue
            body = list(loop.body) + list(getattr(loop, "orelse", []))
            loop_names, loop_attrs = _assigned_names(body)
            if isinstance(loop, (ast.For, ast.AsyncFor)):
                for n in ast.walk(loop.target):
                    if isinstance(n, ast.Name):
                        loop_names.add(n.id)
            for node in _loop_own_nodes(body):
                if not isinstance(node, ast.Call):
                    continue
                h2d = flow.h2d_operand(node)
                if h2d is not None:
                    inv = _invariant_operand(h2d, loop_names, loop_attrs)
                    if inv is not None and _once(node):
                        yield ctx.finding(
                            "torch-loop-invariant-transfer", node,
                            f"H2D upload of loop-invariant {inv} inside "
                            f"a loop (line {loop.lineno}): the same bytes "
                            "cross the bus every iteration; hoist the "
                            "transfer (or the accounted matrix cache) "
                            "out",
                        )
                    continue
                name = call_name(node)
                if name in flow.EXPLICIT_D2H_CALLS or \
                        name in flow.IMPLICIT_SINK_CALLS:
                    op = node.args[0] if node.args else None
                elif isinstance(node.func, ast.Attribute) and \
                        node.func.attr in flow.SINK_METHODS:
                    op = node.func.value
                else:
                    continue
                if op is None:
                    continue
                inv = _invariant_operand(op, loop_names, loop_attrs)
                if inv is not None and \
                        analysis.expr_res(fr, op) == flow.DEVICE and \
                        _once(node):
                    yield ctx.finding(
                        "torch-loop-invariant-transfer", node,
                        f"D2H pull of loop-invariant device value {inv} "
                        f"inside a loop (line {loop.lineno}): pull once"
                        " outside the loop",
                    )


# -- rule: per-call placement-object construction ---------------------------


#: placement-object constructors: the port's mesh types, torch's device
#: mesh and process groups, and CUDA streams
_SHARDING_CTORS = {
    "Mesh", "make_mesh", "Placement", "DeviceMesh", "init_device_mesh",
    "new_group", "Stream", "new_stream",
}


def _in_constructor(node: ast.AST, parents) -> bool:
    """``node`` runs in an ``__init__``/``__post_init__``/``__new__``:
    once per owning object, which is the cache."""
    cur = parents.get(node)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return cur.name in ("__init__", "__post_init__", "__new__")
        cur = parents.get(cur)
    return False


def _sharding_aliases(ctx: FileContext) -> Set[str]:
    names = set(_SHARDING_CTORS)
    for node in ctx.walk():
        if isinstance(node, ast.ImportFrom):
            for a in node.names:
                if a.name in _SHARDING_CTORS and a.asname:
                    names.add(a.asname)
    return names


@rule(
    "torch-percall-sharding-construction", "torch", SEV_WARNING,
    "a placement object (the port's Mesh / make_mesh / Placement, "
    "DeviceMesh / init_device_mesh, a CUDA Stream / new_stream, a "
    "torch.distributed process group) is constructed inside a loop or "
    "inside a compiled function: placement is dispatch-invariant, and "
    "rebuilding it per call re-creates device lists, streams or groups "
    "(the mesh analogue of torch-loop-invariant-transfer).  Build once "
    "and cache -- the mesh plane's sharding() / collective_mesh() "
    "caches (parallel/mesh_plane.py) are the blessed seam",
)
def check_percall_sharding_construction(
    ctx: FileContext,
) -> Iterator[Finding]:
    if not _in_port(ctx) or not ctx.imports_module("torch"):
        return
    names = _sharding_aliases(ctx)
    parents = ctx.parent_map()
    for node in ctx.walk():
        if not isinstance(node, ast.Call):
            continue
        if call_name(node).rsplit(".", 1)[-1] not in names:
            continue
        # ancestry walk: the nearest enclosing loop or compiled function
        # decides; a construction in plain builder code (codec
        # __init__, cache-miss fill) is the sanctioned shape
        cur = parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.For, ast.AsyncFor, ast.While)):
                if _in_constructor(cur, parents):
                    break  # one object per cell, built with its owner
                yield ctx.finding(
                    "torch-percall-sharding-construction", node,
                    f"{call_name(node)} constructed inside a loop "
                    f"(line {cur.lineno}): placement objects are "
                    "loop-invariant -- build once outside (or through "
                    "a keyed cache like mesh_plane.sharding())",
                )
                break
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if _compiled(cur):
                    yield ctx.finding(
                        "torch-percall-sharding-construction", node,
                        f"{call_name(node)} constructed inside compiled "
                        f"function {cur.name}: placement objects belong "
                        "outside the traced computation -- close over "
                        "a cached instance instead",
                    )
                # a function boundary ends the ancestry either way: an
                # enclosing loop re-runs the DEF, not the body
                break
            cur = parents.get(cur)


def _loop_own_nodes(body: List[ast.stmt]) -> Iterator[ast.AST]:
    stack: List[ast.AST] = list(body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))
