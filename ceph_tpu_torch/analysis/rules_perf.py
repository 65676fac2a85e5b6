"""Telemetry-schema rules: perf counters must reach an operator.

``perf-counter-unexported``: a PerfCounters key incremented anywhere in
``ceph_tpu_torch/`` but absent from the telemetry surfaces is invisible in
production -- it exists only for whoever reads the admin socket of the
right daemon at the right moment.  The surfaces are:

* the **report schema** (``ceph_tpu_torch/mgr/report.py``):
  ``REPORTED_COUNTERS`` exact names + ``REPORTED_COUNTER_PREFIXES``
  families -- what ships in MgrReport frames and therefore reaches the
  mgr's aggregated prometheus scrape on the multi-process path;
* the **in-process exposition** (``ceph_tpu_torch/mgr/mgr.py``): counters the
  legacy ClusterState prometheus renderer names explicitly.

Both tables are parsed from the AST (never imported -- the analyzer
must work on a broken tree), mirroring rules_config's OPTIONS
extraction.  Dynamic keys (f-strings, computed names) are skipped; a
counter that is genuinely local gets a justified inline disable.
"""

from __future__ import annotations

import ast
import functools
import os
from typing import Iterator, Optional, Set, Tuple

from ceph_tpu_torch.analysis.core import (SEV_WARNING, FileContext, Finding,
                                    call_attr, call_name,
                                    module_str_constants, rule)

_PERF_METHODS = ("inc", "tinc", "hwm")


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


@functools.lru_cache(maxsize=1)
def report_schema() -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    """(exact names, prefixes) from mgr/report.py's AST."""
    path = os.path.join(_repo_root(), "ceph_tpu_torch", "mgr", "report.py")
    try:
        with open(path) as fh:
            tree = ast.parse(fh.read())
    except (OSError, SyntaxError):
        return (), ()
    names: Tuple[str, ...] = ()
    prefixes: Tuple[str, ...] = ()
    for node in tree.body:
        if not isinstance(node, ast.Assign) or len(node.targets) != 1 \
                or not isinstance(node.targets[0], ast.Name):
            continue
        target = node.targets[0].id
        value = node.value
        if isinstance(value, ast.Call) and \
                call_name(value) == "frozenset" and value.args:
            value = value.args[0]
        if not isinstance(value, (ast.Set, ast.Tuple, ast.List)):
            continue
        literals = tuple(
            e.value for e in value.elts
            if isinstance(e, ast.Constant) and isinstance(e.value, str)
        )
        if target == "REPORTED_COUNTERS":
            names = literals
        elif target == "REPORTED_COUNTER_PREFIXES":
            prefixes = literals
    return names, prefixes


@functools.lru_cache(maxsize=1)
def exposition_literals() -> Tuple[str, ...]:
    """Every string literal in mgr/mgr.py -- the in-process renderer
    names the counters it exposes explicitly, so membership here counts
    as exported (coarse on purpose: a rename that orphans the renderer
    reference then surfaces as an unexported counter at the inc site)."""
    path = os.path.join(_repo_root(), "ceph_tpu_torch", "mgr", "mgr.py")
    try:
        with open(path) as fh:
            tree = ast.parse(fh.read())
    except (OSError, SyntaxError):
        return ()
    return tuple(
        node.value for node in ast.walk(tree)
        if isinstance(node, ast.Constant) and isinstance(node.value, str)
    )


def _counter_key(call: ast.Call, consts) -> Optional[str]:
    if not call.args:
        return None
    arg = call.args[0]
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return arg.value
    if isinstance(arg, ast.Name):
        return consts.get(arg.id)
    return None  # dynamic key: out of scope


@rule(
    "perf-counter-unexported", "ceph", SEV_WARNING,
    "perf counter incremented in ceph_tpu_torch/ but absent from the "
    "telemetry surfaces: not in mgr/report.py's REPORTED_COUNTERS / "
    "REPORTED_COUNTER_PREFIXES schema (so it never rides a MgrReport "
    "frame to the mgr's aggregated scrape) and not named by the "
    "in-process prometheus renderer -- operators cannot see it",
)
def check_perf_counter_unexported(ctx: FileContext) -> Iterator[Finding]:
    path = ctx.path.replace("\\", "/")
    if not path.startswith("ceph_tpu_torch/"):
        return  # tools/tests counters are harness-local by design
    if path.endswith(("mgr/report.py", "mgr/mgr.py")):
        return  # the schema/renderer themselves
    names, prefixes = report_schema()
    if not names and not prefixes:
        return  # schema unreadable: stay silent rather than spam
    exported: Set[str] = set(names) | set(exposition_literals())
    consts = module_str_constants(ctx.tree)
    for node in ctx.walk():
        if not isinstance(node, ast.Call):
            continue
        attr = call_attr(node)
        if attr not in _PERF_METHODS:
            continue
        segments = call_name(node).split(".")
        if len(segments) < 2 or segments[-2] != "perf":
            continue  # not a PerfCounters surface (e.g. dict.update)
        key = _counter_key(node, consts)
        if key is None:
            continue
        if key in exported or key.startswith(tuple(prefixes)):
            continue
        yield ctx.finding(
            "perf-counter-unexported", node,
            f"counter {key!r} is not in the report schema "
            "(mgr/report.py REPORTED_COUNTERS/_PREFIXES) nor named by "
            "the prometheus renderer; add it to the schema or justify "
            "with an inline disable",
        )
