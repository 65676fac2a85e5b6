"""Elastic-membership map-application rule.

``osdmap-apply-unguarded``: every OSDMap broadcast consumer must go
through :func:`ceph_tpu_torch.mon.osdmap.apply_map_view`, which (a) gates on
the committed epoch so a stale or replayed broadcast can never rewind
placement, (b) GROWS the crush map for osd ids past ``n_osds`` (the
pre-elastic fixed-size ``weights[]`` push IndexError'd on the first
``osd add``), and (c) zeroes ids absent from the broadcast so ``osd
rm`` actually drains.  A raw weight-push loop over a map dict --

    for osd_id, w in m["weights"].items():
        placement.weights[int(osd_id)] = w

-- silently reimplements none of those three, so any function that
applies an osdmap's weight table by hand without calling
``apply_map_view`` is flagged.  ``mon/osdmap.py`` itself (the one
legitimate raw-push site, inside apply_map_view) is excluded by path.

Pure AST, like every cephlint rule.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional

from ceph_tpu_torch.analysis.core import (SEV_ERROR, FileContext, Finding,
                                    call_attr, rule)

#: the blessed applicator; a function that calls it may still loop over
#: the dict for bookkeeping (logging, census) without being flagged
_APPLICATOR = "apply_map_view"


def _weights_table(node: ast.expr) -> bool:
    """``X["weights"]`` / ``X.get("weights", ...)`` -- the raw weight
    table of an osdmap broadcast dict."""
    if isinstance(node, ast.Subscript):
        sl = node.slice
        return isinstance(sl, ast.Constant) and sl.value == "weights"
    if isinstance(node, ast.Call) and call_attr(node) == "get" and \
            node.args and isinstance(node.args[0], ast.Constant) and \
            node.args[0].value == "weights":
        return True
    return False


def _iterates_weights(it: ast.expr) -> bool:
    """The loop walks a broadcast's weight table, directly or via
    ``.items()``/``.keys()``."""
    if _weights_table(it):
        return True
    if isinstance(it, ast.Call) and call_attr(it) in ("items", "keys") \
            and isinstance(it.func, ast.Attribute):
        return _weights_table(it.func.value)
    return False


def _pushes_weight(loop: ast.For) -> Optional[ast.AST]:
    """First statement in the loop body that writes a placement weight
    slot (``<anything>.weights[...] = ...``, incl. augmented)."""
    for node in ast.walk(loop):
        targets = ()
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AugAssign):
            targets = (node.target,)
        for t in targets:
            if isinstance(t, ast.Subscript) and \
                    isinstance(t.value, ast.Attribute) and \
                    t.value.attr == "weights":
                return node
    return None


def _scope_calls_applicator(scope: ast.AST) -> bool:
    for node in ast.walk(scope):
        if isinstance(node, ast.Call) and call_attr(node) == _APPLICATOR:
            return True
    return False


@rule(
    "osdmap-apply-unguarded",
    "ceph",
    SEV_ERROR,
    "osdmap weight table applied by a raw push loop instead of "
    "apply_map_view: no epoch gate (stale broadcasts rewind placement), "
    "no growth for new osd ids (IndexError on the first osd add), no "
    "zeroing of removed ids (osd rm never drains)",
)
def check_osdmap_apply_unguarded(ctx: FileContext) -> Iterator[Finding]:
    path = ctx.path.replace("\\", "/")
    if path.endswith("mon/osdmap.py"):
        return
    parents = ctx.parent_map()
    for node in ctx.walk():
        if not isinstance(node, ast.For):
            continue
        if not _iterates_weights(node.iter):
            continue
        if _pushes_weight(node) is None:
            continue
        # the raw push is fine only when its OWN enclosing function
        # (or the module body, for top-level code) also routes the
        # broadcast through apply_map_view
        scope: ast.AST = node
        while scope in parents and not isinstance(
                scope, (ast.FunctionDef, ast.AsyncFunctionDef)):
            scope = parents[scope]
        if not isinstance(scope, (ast.FunctionDef, ast.AsyncFunctionDef)):
            scope = ctx.tree
        if _scope_calls_applicator(scope):
            continue
        yield ctx.finding(
            "osdmap-apply-unguarded", node,
            "raw osdmap weight push: route this broadcast through "
            "apply_map_view (epoch gate + crush growth + removed-id "
            "zeroing) instead of assigning weights[] by hand")
