"""Baseline file: accepted legacy findings + the inline-disable audit.

Port of ``ceph_tpu/analysis/baseline.py``, in the same file format
(``format_version`` 1): each package's baseline file reads in the
other's loader.

The baseline lets the gate enforce "no NEW findings" without
requiring every legacy finding to be fixed in the PR that introduces a
rule.  Entries match on ``(rule, path, hash of the stripped source
line)`` rather than line numbers, so unrelated edits above a baselined
site don't invalidate it; each entry carries a count, so N accepted
instances of the same line text cover exactly N findings and the N+1st
is NEW.

Workflow:
  * ``ceph_tpu_torch/tools/cephlint.py --write-baseline`` regenerates the file from the
    current findings (review the diff -- every added entry is a finding
    you are accepting instead of fixing);
  * the checked-in file also carries ``suppressions``: an audit listing
    of every inline ``# cephlint: disable`` in the tree, regenerated on
    every --write-baseline, so accepted escapes are reviewable in one
    place.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, List, Tuple

from ceph_tpu_torch.analysis.core import Finding

FORMAT_VERSION = 1


def _line_text(lines: List[str], lineno: int) -> str:
    if 1 <= lineno <= len(lines):
        return lines[lineno - 1].strip()
    return ""


def finding_key(f: Finding, lines: List[str]) -> Tuple[str, str, str]:
    digest = hashlib.sha1(
        _line_text(lines, f.line).encode("utf-8", "replace")
    ).hexdigest()[:12]
    return (f.rule, f.path, digest)


def load(path: str) -> Dict[Tuple[str, str, str], int]:
    """Baseline as key -> accepted count; {} when absent."""
    if not path or not os.path.exists(path):
        return {}
    with open(path) as fh:
        data = json.load(fh)
    out: Dict[Tuple[str, str, str], int] = {}
    for e in data.get("findings", []):
        key = (e["rule"], e["path"], e["line_hash"])
        out[key] = out.get(key, 0) + int(e.get("count", 1))
    return out


def write(path: str, findings: List[Finding],
          file_lines: Dict[str, List[str]],
          suppression_audit: List[dict]) -> None:
    counted: Dict[Tuple[str, str, str], int] = {}
    for f in findings:
        key = finding_key(f, file_lines.get(f.path, []))
        counted[key] = counted.get(key, 0) + 1
    entries = [
        {"rule": r, "path": p, "line_hash": h, "count": c}
        for (r, p, h), c in sorted(counted.items())
    ]
    with open(path, "w") as fh:
        json.dump(
            {
                "format_version": FORMAT_VERSION,
                "comment": "accepted legacy cephlint findings; regenerate "
                           "with ceph_tpu_torch/tools/cephlint.py "
                           "--write-baseline and review the diff",
                "findings": entries,
                "suppressions": suppression_audit,
            },
            fh, indent=2, sort_keys=False,
        )
        fh.write("\n")


def split(findings: List[Finding],
          file_lines: Dict[str, List[str]],
          accepted: Dict[Tuple[str, str, str], int]
          ) -> Tuple[List[Finding], List[Finding]]:
    """(new, baselined) -- consumes ``accepted`` counts in order."""
    budget = dict(accepted)
    new: List[Finding] = []
    old: List[Finding] = []
    for f in findings:
        key = finding_key(f, file_lines.get(f.path, []))
        if budget.get(key, 0) > 0:
            budget[key] -= 1
            old.append(f)
        else:
            new.append(f)
    return new, old
