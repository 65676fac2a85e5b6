"""Inline suppressions: ``# cephlint: disable=<rule>[,<rule>...]``.

Two spellings, mirroring the common linter convention (rule name goes
right after the ``=``):

* same-line: append ``# cephlint: disable=`` + the rule name to the
  flagged line, e.g. to excuse one deliberate blocking call;
* next-line: put ``# cephlint: disable-next-line=`` + the rule name on
  the line above the finding.

``disable=all`` suppresses every rule on that line.  Suppressions are
deliberately line-scoped (no file/block scope): a suppression should sit
next to the code it excuses, where review sees both together.  The
baseline file is the mechanism for bulk legacy acceptance.

Native (.c/.cpp) sources use their own comment syntax, so the marker
also matches after ``//`` or inside ``/* ... */`` (the rule-name
character class naturally excludes the closing ``*/``).
"""

from __future__ import annotations

import re
from typing import Dict, List, Set

_RE = re.compile(
    r"(?:#|//|/\*)\s*cephlint:\s*(disable|disable-next-line)\s*=\s*"
    r"([A-Za-z0-9_\-]+(?:\s*,\s*[A-Za-z0-9_\-]+)*)"
)


def parse_suppressions(source: str) -> Dict[int, Set[str]]:
    """Map of 1-based line number -> set of suppressed rule names
    (``{"all"}`` for disable=all) effective on that line."""
    out: Dict[int, Set[str]] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        m = _RE.search(line)
        if not m:
            continue
        rules = {r.strip() for r in m.group(2).split(",") if r.strip()}
        target = i + 1 if m.group(1) == "disable-next-line" else i
        out.setdefault(target, set()).update(rules)
    return out


def is_suppressed(suppressions: Dict[int, Set[str]], rule: str,
                  line: int) -> bool:
    rules = suppressions.get(line)
    return bool(rules) and ("all" in rules or rule in rules)


def audit(path: str, source: str) -> List[dict]:
    """Every inline disable in a file, for the baseline's suppression
    audit listing (so accepted escapes stay reviewable in one place)."""
    out = []
    for i, line in enumerate(source.splitlines(), start=1):
        m = _RE.search(line)
        if m:
            out.append({
                "path": path,
                "line": i,
                "kind": m.group(1),
                "rules": sorted(r.strip() for r in m.group(2).split(",")),
                "code": line.strip()[:160],
            })
    return out
