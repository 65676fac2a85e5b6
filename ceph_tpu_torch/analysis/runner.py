"""cephlint runner: collect files, run rules, apply suppressions and
the baseline, format results (port of ``ceph_tpu/analysis/runner.py``;
the default scan is the port's tree, see ``tools/cephlint.py``)."""

from __future__ import annotations

import ast
import json
import os
import time
from typing import Dict, Iterable, List, Optional, Tuple

from ceph_tpu_torch.analysis import baseline as baseline_mod
from ceph_tpu_torch.analysis import suppress as suppress_mod
from ceph_tpu_torch.analysis.core import (SEV_ERROR, FileContext, Finding, Rule,
                                    all_rules)

#: paths skipped by default: the lint fixtures are DELIBERATE findings
#: (each rule's positive examples) and would otherwise fail the gate --
#: the JAX package's fixtures and the port's translated ``torch`` ones
DEFAULT_EXCLUDES = ("tests/fixtures/lint/", "tests/fixtures/lint_torch/")

#: what ``tools/cephlint.py`` scans when given no paths: the port, its
#: smoke script and the port's own test files
DEFAULT_PATHS = ("ceph_tpu_torch", "chip_smoke.py", "tests/test_torch_*.py",
                 "tests/torch_*.py")

#: native-extension sources the ``native`` pack scans (everything else
#: runs the Python-AST packs)
NATIVE_EXTS = (".c", ".cpp", ".cc", ".h")


def _is_native(path: str) -> bool:
    return path.endswith(NATIVE_EXTS)


def repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def collect_files(paths: Iterable[str], root: Optional[str] = None,
                  excludes: Tuple[str, ...] = DEFAULT_EXCLUDES
                  ) -> List[str]:
    """Expand files/directories into a sorted list of repo-relative
    posix paths to .py and native (.c/.cpp) files."""
    import glob

    root = root or repo_root()
    out = set()
    expanded: List[str] = []
    for p in paths:
        full = p if os.path.isabs(p) else os.path.join(root, p)
        expanded.extend(sorted(glob.glob(full)) if glob.has_magic(full)
                        else [full])
    for full in expanded:
        if os.path.isfile(full):
            out.add(os.path.relpath(full, root))
        else:
            for dirpath, dirnames, filenames in os.walk(full):
                dirnames[:] = [d for d in dirnames
                               if d not in ("__pycache__", ".git")]
                for fn in filenames:
                    if fn.endswith(".py") or _is_native(fn):
                        out.add(os.path.relpath(
                            os.path.join(dirpath, fn), root))
    rel = sorted(p.replace(os.sep, "/") for p in out)
    return [p for p in rel
            if not any(p.startswith(e) for e in excludes)]


class ScanResult:
    def __init__(self):
        self.new: List[Finding] = []          # unsuppressed, not baselined
        self.suppressed: List[Finding] = []   # inline-disabled
        self.baselined: List[Finding] = []    # accepted legacy
        self.files_scanned = 0
        self.suppression_audit: List[dict] = []
        #: raw per-file lines (baseline hashing)
        self.file_lines: Dict[str, List[str]] = {}
        #: analysis wall time (the JSON's lint_runtime_secs)
        self.runtime_secs = 0.0
        #: names of the rules this scan ran (all, or a --rule subset)
        self.rules_run: List[str] = []

    @property
    def all_findings(self) -> List[Finding]:
        return self.new + self.suppressed + self.baselined

    def to_dict(self) -> dict:
        counts: Dict[str, int] = {}
        for f in self.new:
            counts[f.rule] = counts.get(f.rule, 0) + 1
        return {
            "lint_findings_total": len(self.new),
            "lint_findings_by_rule": dict(sorted(counts.items())),
            "lint_runtime_secs": round(self.runtime_secs, 3),
            "files_scanned": self.files_scanned,
            "suppressed": len(self.suppressed),
            "baselined": len(self.baselined),
            "rules_run": list(self.rules_run),
            # legacy spelling kept for older consumers of the JSON
            "counts_by_rule": dict(sorted(counts.items())),
            "findings": [f.to_dict() for f in self.new],
        }


def resolve_rules(names: Optional[Iterable[str]] = None) -> Dict[str, Rule]:
    """The rule set a scan runs: every registered rule, or the ``--rule``
    subset (unknown names raise with the valid spellings listed)."""
    registry = all_rules()
    if not names:
        return registry
    out: Dict[str, Rule] = {}
    for name in names:
        if name not in registry:
            known = ", ".join(sorted(registry))
            raise ValueError(f"unknown rule {name!r}; known rules: {known}")
        out[name] = registry[name]
    return out


def scan_file(path: str, source: str,
              rules: Optional[Dict[str, Rule]] = None) -> List[Finding]:
    """All raw findings for one file (no suppression/baseline yet).
    Native (.c/.cpp) sources run the ``native`` pack against the C
    model; Python sources run every other pack against the AST."""
    rule_set = rules if rules is not None else all_rules()
    findings: List[Finding] = []
    if _is_native(path):
        from ceph_tpu_torch.analysis.rules_native import NativeFileContext

        nctx = NativeFileContext(path, source)
        for r in rule_set.values():
            if r.pack == "native":
                findings.extend(r.check(nctx))
        findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
        return findings
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Finding("parse-error", path, e.lineno or 1, 0,
                        f"file does not parse: {e.msg}", SEV_ERROR)]
    ctx = FileContext(path, source, tree)
    for r in rule_set.values():
        if r.pack == "native":
            continue
        findings.extend(r.check(ctx))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def run_paths(paths: Iterable[str], root: Optional[str] = None,
              baseline_path: Optional[str] = None,
              excludes: Tuple[str, ...] = DEFAULT_EXCLUDES,
              rules: Optional[Iterable[str]] = None) -> ScanResult:
    root = root or repo_root()
    t0 = time.monotonic()
    rule_set = resolve_rules(rules)
    result = ScanResult()
    result.rules_run = sorted(rule_set)
    accepted = baseline_mod.load(baseline_path) if baseline_path else {}
    for rel in collect_files(paths, root, excludes):
        try:
            with open(os.path.join(root, rel), encoding="utf-8") as fh:
                source = fh.read()
        except OSError:
            continue
        result.files_scanned += 1
        result.file_lines[rel] = source.splitlines()
        raw = scan_file(rel, source, rule_set)
        result.suppression_audit.extend(suppress_mod.audit(rel, source))
        if not raw:
            continue
        sup = suppress_mod.parse_suppressions(source)
        live = []
        for f in raw:
            if suppress_mod.is_suppressed(sup, f.rule, f.line):
                result.suppressed.append(f)
            else:
                live.append(f)
        new, old = baseline_mod.split(live, result.file_lines, accepted)
        result.new.extend(new)
        result.baselined.extend(old)
    result.runtime_secs = time.monotonic() - t0
    return result


def changed_files(root: Optional[str] = None) -> List[str]:
    """Repo-relative .py and native .c/.cpp files differing from HEAD
    (staged, unstaged, and untracked) -- the ``--changed`` scan scope.
    Empty when git is unavailable (callers fall back to a full scan or
    a no-op)."""
    import subprocess

    root = root or repo_root()
    out: set = set()
    for args in (["git", "diff", "--name-only", "HEAD", "--"],
                 ["git", "ls-files", "--others", "--exclude-standard"]):
        try:
            proc = subprocess.run(args, cwd=root, capture_output=True,
                                  text=True, timeout=30)
        except (OSError, subprocess.TimeoutExpired):
            return []
        if proc.returncode != 0:
            return []
        for line in proc.stdout.splitlines():
            line = line.strip()
            if (line.endswith(".py") or _is_native(line)) and \
                    os.path.exists(os.path.join(root, line)):
                out.add(line.replace(os.sep, "/"))
    return sorted(out)


def to_sarif(result: ScanResult) -> dict:
    """SARIF 2.1.0 document for CI diff annotation (GitHub code
    scanning et al. ingest this directly).  Only NEW findings are
    results -- suppressed/baselined debt is the text/json surface's
    business, a diff annotator wants exactly what fails the gate."""
    registry = all_rules()
    used = sorted({f.rule for f in result.new})
    rules_meta = []
    for name in used:
        r = registry.get(name)
        rules_meta.append({
            "id": name,
            "shortDescription": {
                "text": (r.description if r is not None
                         else "cephlint finding")},
            "defaultConfiguration": {
                "level": ("error" if (r and r.severity == SEV_ERROR)
                          else "warning")},
        })
    results = []
    for f in result.new:
        results.append({
            "ruleId": f.rule,
            "level": "error" if f.severity == SEV_ERROR else "warning",
            "message": {"text": f.message},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {"uri": f.path,
                                         "uriBaseId": "SRCROOT"},
                    "region": {"startLine": max(1, f.line),
                               "startColumn": f.col + 1},
                }
            }],
        })
    return {
        "$schema": ("https://raw.githubusercontent.com/oasis-tcs/"
                    "sarif-spec/master/Schemata/sarif-schema-2.1.0.json"),
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "cephlint",
                "informationUri": "ceph_tpu_torch/analysis/__init__.py",
                "rules": rules_meta,
            }},
            "columnKind": "utf16CodeUnits",
            "results": results,
        }],
    }


def run(paths: Iterable[str], fmt: str = "text",
        baseline_path: Optional[str] = None,
        root: Optional[str] = None,
        excludes: Tuple[str, ...] = DEFAULT_EXCLUDES,
        rules: Optional[Iterable[str]] = None) -> Tuple[int, str]:
    """(exit_code, rendered_output); exit 0 iff no new findings."""
    result = run_paths(paths, root=root, baseline_path=baseline_path,
                       excludes=excludes, rules=rules)
    if fmt == "json":
        out = json.dumps(result.to_dict(), indent=2)
    elif fmt == "sarif":
        out = json.dumps(to_sarif(result), indent=2)
    else:
        lines = [f.format() for f in result.new]
        lines.append(
            f"cephlint: {len(result.new)} finding(s) in "
            f"{result.files_scanned} files "
            f"({len(result.suppressed)} inline-suppressed, "
            f"{len(result.baselined)} baselined, "
            f"{result.runtime_secs:.2f}s)"
        )
        out = "\n".join(lines)
    return (1 if result.new else 0), out
