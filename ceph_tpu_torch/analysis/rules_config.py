"""Ceph invariant rules: the options registry and encode/decode pairing.

* ``ceph-config-undeclared-key``: the reference declares every option
  once in src/common/options.cc; readers then cannot drift from the
  schema.  Here the same single-declaration invariant is
  ``utils/config.py``'s OPTIONS dict.  The rule covers both access
  styles: ``get_val("<name>")``/``set_val("<name>", ...)`` (raise at runtime only
  when the bad key is actually hit) and the raw env layer
  (``os.environ.get("CEPH_TPU_TORCH_<NAME>")``), which never raises and so drifts
  silently.
The encode/decode pairing rule moved to :mod:`rules_wire` when it grew
flow-aware (field-sequence symmetry, append-only trailing compat).
"""

from __future__ import annotations

import ast
import functools
import os
from typing import Dict, Iterator, List, Optional, Set, Tuple

from ceph_tpu_torch.analysis.core import (SEV_ERROR, FileContext, Finding,
                                    call_attr, call_name,
                                    module_str_constants, rule)

#: the port's environment layer (``utils/config.py`` ``ENV_PREFIX``; the
#: JAX package reads ``CEPH_TPU_<NAME>``)
_ENV_PREFIX = "CEPH_TPU_TORCH_"
_CONFIG_REL_PATH = os.path.join("ceph_tpu_torch", "utils", "config.py")


@functools.lru_cache(maxsize=1)
def declared_options() -> Tuple[str, ...]:
    """Option names declared in utils/config.py, extracted from its AST
    (never imported: the analyzer must work on a broken tree)."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    cfg_path = os.path.join(root, _CONFIG_REL_PATH)
    try:
        with open(cfg_path) as fh:
            tree = ast.parse(fh.read())
    except (OSError, SyntaxError):
        return ()
    names: List[str] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and \
                call_name(node) in ("_opt", "Option") and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str):
            names.append(node.args[0].value)
    return tuple(names)


def _env_key_node(call: ast.Call) -> Optional[ast.expr]:
    name = call_name(call)
    if name in ("os.environ.get", "os.getenv", "environ.get") and call.args:
        return call.args[0]
    return None


def _literal_str(node: ast.expr, consts: Dict[str, str]) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.Name):
        return consts.get(node.id)
    return None


@rule(
    "ceph-config-undeclared-key", "ceph", SEV_ERROR,
    "config key read/written but never declared in the utils/config.py "
    "OPTIONS registry: lookups and the schema can drift apart (typo'd "
    "keys, phantom env knobs with no default, no description, no "
    "`config show`)",
)
def check_undeclared_key(ctx: FileContext) -> Iterator[Finding]:
    if ctx.path.replace("\\", "/").endswith("ceph_tpu_torch/utils/config.py"):
        return  # the registry itself builds keys dynamically
    options: Set[str] = set(declared_options())
    if not options:
        return  # registry unreadable: stay silent rather than spam
    consts = module_str_constants(ctx.tree)
    for node in ctx.walk():
        if isinstance(node, ast.Call):
            if call_attr(node) in ("get_val", "set_val") and node.args:
                key = _literal_str(node.args[0], consts)
                if key is not None and key not in options:
                    yield ctx.finding(
                        "ceph-config-undeclared-key", node,
                        f"option {key!r} is not declared in the "
                        "utils/config.py OPTIONS registry",
                    )
                continue
            env_arg = _env_key_node(node)
            if env_arg is not None:
                key = _literal_str(env_arg, consts)
                if key and key.startswith(_ENV_PREFIX) and \
                        key[len(_ENV_PREFIX):].lower() not in options:
                    yield ctx.finding(
                        "ceph-config-undeclared-key", node,
                        f"env knob {key!r} has no `"
                        f"{key[len(_ENV_PREFIX):].lower()}` option in "
                        "the utils/config.py OPTIONS registry (the env "
                        "layer reads CEPH_TPU_TORCH_<NAME>; undeclared keys "
                        "are invisible to `config show`)",
                    )
        elif isinstance(node, (ast.Subscript,)) and \
                call_name_of_sub(node) == "os.environ":
            key = _literal_str(node.slice, consts)
            if key and key.startswith(_ENV_PREFIX) and \
                    key[len(_ENV_PREFIX):].lower() not in options:
                yield ctx.finding(
                    "ceph-config-undeclared-key", node,
                    f"env knob {key!r} (subscript access) has no "
                    f"`{key[len(_ENV_PREFIX):].lower()}` option in the "
                    "utils/config.py OPTIONS registry",
                )


def call_name_of_sub(node: ast.Subscript) -> str:
    from ceph_tpu_torch.analysis.core import dotted_name

    return dotted_name(node.value)


# NOTE: the encode/decode pairing rule that used to live here
# (ceph-encoding-version-pair) grew into the flow-aware wire-schema
# pack: see rules_wire.py (wire-version-pairing carries the old
# checks; wire-schema-symmetry / wire-trailing-compat add the field
# sequence and append-only compat analysis).
