#!/usr/bin/env python3
"""cephlint CLI: AST-based static analysis over the ceph_tpu_torch tree.

Port of ``tools/cephlint.py``, with the same flags and text / json /
sarif output, pointed at the port:

  python ceph_tpu_torch/tools/cephlint.py          # the port's gate
  python ceph_tpu_torch/tools/cephlint.py --format json | jq .lint_findings_total
  python ceph_tpu_torch/tools/cephlint.py --changed
  python ceph_tpu_torch/tools/cephlint.py --rule torch-recompile-hazard ceph_tpu_torch
  python ceph_tpu_torch/tools/cephlint.py --write-baseline
  python ceph_tpu_torch/tools/cephlint.py --list-rules

With no paths it scans ``ceph_tpu_torch``, ``chip_smoke.py`` and the
port's test files (``tests/test_torch_*.py``, ``tests/torch_*.py``).
Exit code 0 means zero NEW findings (inline-suppressed and baselined
findings don't count); ``tests/test_torch_cephlint.py`` runs exactly this
scan as the port's gate.  The rule catalog, the suppression syntax and
the baseline workflow are in ``ceph_tpu_torch/analysis/__init__.py``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

if __package__ in (None, ""):  # run as a script: the repo root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

from ceph_tpu_torch.analysis import baseline as baseline_mod  # noqa: E402
from ceph_tpu_torch.analysis import runner  # noqa: E402
from ceph_tpu_torch.analysis.core import all_rules  # noqa: E402

DEFAULT_BASELINE = os.path.join("ceph_tpu_torch", "tools",
                                "cephlint_baseline.json")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("paths", nargs="*", default=None,
                    help="files/directories/globs to scan (default: "
                         + " ".join(runner.DEFAULT_PATHS) + ")")
    ap.add_argument("--format", choices=("text", "json", "sarif"),
                    default="text",
                    help="sarif emits a SARIF 2.1.0 document (new "
                         "findings only) for CI diff annotation; see "
                         "ceph_tpu_torch/tools/ci_lint.sh")
    ap.add_argument("--baseline", default=None,
                    help=f"baseline file (default {DEFAULT_BASELINE} "
                         "when it exists)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline (report accepted legacy "
                         "findings too)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="accept the current findings: regenerate the "
                         "baseline file (plus the inline-disable audit) "
                         "and exit 0")
    ap.add_argument("--include-fixtures", action="store_true",
                    help="also scan tests/fixtures/lint and "
                         "tests/fixtures/lint_torch (the deliberate "
                         "positive examples; excluded by default)")
    ap.add_argument("--rule", action="append", default=None,
                    metavar="NAME",
                    help="run only this rule (repeatable); unknown "
                         "names list the valid spellings")
    ap.add_argument("--changed", action="store_true",
                    help="scan only .py and native .c/.cpp files "
                         "differing from git HEAD (staged, unstaged and "
                         "untracked) inside the scan scope; exits 0 "
                         "immediately when nothing changed")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        for r in sorted(all_rules().values(), key=lambda r: (r.pack, r.name)):
            print(f"{r.name}  [{r.pack}/{r.severity}]\n    {r.description}")
        return 0

    root = runner.repo_root()
    paths = args.paths or list(runner.DEFAULT_PATHS)
    excludes = () if args.include_fixtures else runner.DEFAULT_EXCLUDES
    if args.changed:
        scope = set(runner.collect_files(paths, root, excludes))
        paths = [c for c in runner.changed_files(root) if c in scope]
        if not paths:
            if args.format == "json":
                print(json.dumps(runner.ScanResult().to_dict(), indent=2))
            elif args.format == "sarif":
                print(json.dumps(runner.to_sarif(runner.ScanResult()),
                                 indent=2))
            else:
                print("cephlint: no changed files in scope")
            return 0

    baseline_path = args.baseline
    if baseline_path is None:
        cand = os.path.join(root, DEFAULT_BASELINE)
        baseline_path = cand if os.path.exists(cand) else None
    if args.no_baseline:
        baseline_path = None

    if args.write_baseline:
        result = runner.run_paths(paths, root=root, baseline_path=None,
                                  excludes=excludes)
        out_path = args.baseline or os.path.join(root, DEFAULT_BASELINE)
        # inline-suppressed findings stay OUT of the baseline (their
        # acceptance lives next to the code); everything else in
        baseline_mod.write(out_path, result.new, result.file_lines,
                           result.suppression_audit)
        print(f"cephlint: wrote {len(result.new)} accepted finding(s) and "
              f"{len(result.suppression_audit)} inline-disable audit "
              f"entries to {os.path.relpath(out_path, root)}")
        return 0

    try:
        code, out = runner.run(paths, fmt=args.format,
                               baseline_path=baseline_path, root=root,
                               excludes=excludes, rules=args.rule)
    except ValueError as e:  # unknown --rule name
        print(f"cephlint: {e}", file=sys.stderr)
        return 2
    print(out)
    return code


if __name__ == "__main__":
    sys.exit(main())
