"""The port's static checker (``ceph_tpu_torch/analysis/``, its CLI
``ceph_tpu_torch/tools/cephlint.py``, the baseline and ``ci_lint.sh``)
against the JAX package's (``tests/test_cephlint.py`` there).

* The language-neutral packs (async, interleave, config, perf, profile,
  trace, osdmap, wire, native): both packages' runners scan each of the
  JAX package's fixtures in ``tests/fixtures/lint/``, written under a
  temporary root at the path each package scopes (``ceph_tpu/...`` or
  ``ceph_tpu_torch/...``; the port's copy names the port's modules and
  its ``CEPH_TPU_TORCH_`` environment layer), and must give the same
  ``(rule, line)`` set.
* The ``torch`` pack: the translated fixtures in
  ``tests/fixtures/lint_torch/`` fire exactly where annotated.
* The port's gate: zero new findings over the port's tree with the
  port's baseline, inside 30 s.
"""

from __future__ import annotations

import ast
import json
import os
import re
import subprocess
import sys
import textwrap

import pytest

from ceph_tpu.analysis import baseline as j_baseline
from ceph_tpu.analysis import runner as j_runner
from ceph_tpu.analysis.core import all_rules as j_all_rules
from ceph_tpu.utils.config import OPTIONS as J_OPTIONS
from ceph_tpu_torch.analysis import baseline as baseline_mod
from ceph_tpu_torch.analysis import runner
from ceph_tpu_torch.analysis import suppress as suppress_mod
from ceph_tpu_torch.analysis.core import FileContext, all_rules
from ceph_tpu_torch.analysis.runner import scan_file
from ceph_tpu_torch.utils.config import OPTIONS

REPO = runner.repo_root()
LINT = os.path.join(REPO, "tests", "fixtures", "lint")
LINT_TORCH = os.path.join(REPO, "tests", "fixtures", "lint_torch")
CLI = os.path.join(REPO, "ceph_tpu_torch", "tools", "cephlint.py")
ENV = dict(os.environ, PYTHONPATH=REPO)

#: the JAX package's fixtures of the language-neutral packs -> the path
#: its gate presents them under (None: a path no rule scopes)
SHARED = {
    "async_orphan_task.py": None,
    "async_unawaited_coroutine.py": None,
    "async_blocking_call.py": None,
    "async_sync_lock_await.py": None,
    "async_drain_per_item.py": None,
    "async_unbounded_retry.py": None,
    "async_rmw_across_await.py": None,
    "async_lock_across_await.py": None,
    "async_background_unthrottled.py": None,
    "async_unbounded_fanout.py": None,
    "async_atomic_section.py": None,
    "ceph_config_undeclared.py": None,
    "osdmap_apply_unguarded.py": None,
    "perf_counter_unexported.py": "ceph_tpu/osd/_fixture_perf_export.py",
    "trace_span_unfinished.py": None,
    "profile_stage_unpaired.py": None,
    "wire_symmetry.py": None,
    "wire_hot_path_alloc.py": None,
    "suppressions.py": None,
    "native_refcount_leak.c": None,
    "native_gil_pyapi.c": None,
    "native_missing_fallback.c": None,
    "native_schema_drift.c": None,
}

#: the port's ``torch`` fixtures -> the port path they are presented under
TORCH = {
    "torch_gf_dtype_drift.py": "ceph_tpu_torch/ops/_fixture_dtype.py",
    "torch_device_bytes_unaccounted.py":
        "ceph_tpu_torch/osd/_fixture_device_bytes.py",
    "torch_d2h_resident_section.py": None,
    "torch_recompile_hazard.py": "ceph_tpu_torch/ops/_fixture_recompile.py",
    "torch_donated_after_use.py": None,
    "torch_loop_invariant_transfer.py":
        "ceph_tpu_torch/ops/_fixture_loopinv.py",
    "torch_percall_sharding_construction.py":
        "ceph_tpu_torch/parallel/_fixture_sharding.py",
}

_ANNOT = re.compile(r"(?:#|//)\s*LINT:\s*([a-z0-9\-]+(?:\s*,\s*[a-z0-9\-]+)*)")


def _expected(source: str):
    out = set()
    for i, line in enumerate(source.splitlines(), start=1):
        m = _ANNOT.search(line)
        if m:
            out |= {(r.strip(), i) for r in m.group(1).split(",")}
    return out


def _to_port(source: str) -> str:
    """The fixture as the port's code spells it (same lines)."""
    source = re.sub(r"\bceph_tpu\b(?!_torch)", "ceph_tpu_torch", source)
    return re.sub(r"\bCEPH_TPU_(?!TORCH_)", "CEPH_TPU_TORCH_", source)


def _read(directory: str, name: str) -> str:
    with open(os.path.join(directory, name), encoding="utf-8") as fh:
        return fh.read()


def _lint(path: str, source: str):
    """The runner's per-file pipeline without a baseline: (new,
    suppressed)."""
    raw = scan_file(path, source)
    sup = suppress_mod.parse_suppressions(source)
    new = [f for f in raw
           if not suppress_mod.is_suppressed(sup, f.rule, f.line)]
    return new, [f for f in raw if f not in new]


def _paths(fixture: str):
    """(the JAX package's path, the port's) for a shared fixture."""
    jpath = SHARED[fixture] or f"lintcase/{fixture}"
    return jpath, jpath.replace("ceph_tpu/", "ceph_tpu_torch/")


def _scan_both(tmp_path, fixture: str):
    """({(rule, line)} of the JAX package's runner, of the port's), each
    over the fixture written under its own root at its scoped path."""
    source = _read(LINT, fixture)
    jpath, tpath = _paths(fixture)
    got = []
    for mod, root, rel, text in (
            (j_runner, tmp_path / "jax", jpath, source),
            (runner, tmp_path / "port", tpath, _to_port(source))):
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_text(text)
        res = mod.run_paths([rel], root=str(root), excludes=())
        assert res.files_scanned == 1
        got.append({(f.rule, f.line) for f in res.new + res.suppressed})
    return got[0], got[1], source


@pytest.mark.parametrize("fixture", sorted(SHARED))
def test_shared_fixture_findings_match_the_jax_package(tmp_path, fixture):
    theirs, mine, source = _scan_both(tmp_path, fixture)
    assert theirs, fixture  # every fixture holds positives
    lines = _to_port(source).splitlines()
    extra = mine - theirs
    # the one difference by design: the port declares only the options
    # it reads, so a key only the JAX package declares is undeclared here
    for rule_name, line in extra:
        key = re.search(r'_val\("(\w+)"', lines[line - 1])
        assert rule_name == "ceph-config-undeclared-key" and key and \
            key.group(1) in set(J_OPTIONS) - set(OPTIONS), (rule_name, line)
    assert theirs <= mine
    new, _sup = _lint(_paths(fixture)[1], _to_port(source))
    assert {(f.rule, f.line) for f in new} == _expected(source) | extra


@pytest.mark.parametrize("fixture", sorted(TORCH))
def test_torch_fixture_rules_fire_exactly_where_annotated(fixture):
    source = _read(LINT_TORCH, fixture)
    new, _sup = _lint(TORCH[fixture] or f"tests/fixtures/lint_torch/{fixture}",
                      source)
    got = {(f.rule, f.line) for f in new}
    want = _expected(source)
    assert got == want, (f"unexpected: {sorted(got - want)}; "
                         f"missed: {sorted(want - got)}")


def test_every_rule_has_a_positive_fixture():
    fired = set()
    for fixture in SHARED:
        new, sup = _lint(_paths(fixture)[1], _to_port(_read(LINT, fixture)))
        fired |= {f.rule for f in new + sup}
    for fixture, pseudo in TORCH.items():
        new, sup = _lint(pseudo or f"lintcase/{fixture}",
                         _read(LINT_TORCH, fixture))
        fired |= {f.rule for f in new + sup}
    assert set(all_rules()) == fired


def test_rule_catalog_has_a_counterpart_of_every_jax_rule():
    mine, theirs = all_rules(), j_all_rules()
    assert len(mine) == len(theirs) == 31
    assert set(mine) == {n.replace("jax-", "torch-", 1) for n in theirs}
    for name, r in theirs.items():
        ported = mine[name.replace("jax-", "torch-", 1)]
        assert (ported.pack, ported.severity) == \
            (r.pack.replace("jax", "torch"), r.severity), name
    out = subprocess.run([sys.executable, CLI, "--list-rules"],
                         capture_output=True, text=True, env=ENV)
    assert out.returncode == 0
    listed = [ln.split()[0] for ln in out.stdout.splitlines()
              if ln and not ln.startswith(" ")]
    assert sorted(listed) == sorted(mine)


def test_both_gates_skip_the_fixture_directories():
    # the JAX package's default exclude is a prefix, so it skips the
    # port's translated fixtures too
    assert j_runner.DEFAULT_EXCLUDES == ("tests/fixtures/lint",)
    fixtures = set(j_runner.collect_files(["tests/fixtures"],
                                          excludes=()))
    assert any(p.startswith("tests/fixtures/lint_torch/") for p in fixtures)
    for mod in (j_runner, runner):
        kept = mod.collect_files(["tests/fixtures"])
        assert not any(p.startswith("tests/fixtures/lint") for p in kept)
    scope = runner.collect_files(list(runner.DEFAULT_PATHS))
    assert "chip_smoke.py" in scope and "tests/torch_verify.py" in scope
    assert not any(p.startswith(("ceph_tpu/", "tools/")) for p in scope)


def test_suppression_buckets():
    source = _to_port(_read(LINT, "suppressions.py"))
    new, suppressed = _lint("lintcase/suppressions.py", source)
    assert len(suppressed) == 3
    assert {f.rule for f in new} == {"async-blocking-call"}
    assert len(suppress_mod.audit("x.py", source)) == 4


#: the fault shapes that motivated the async and interleave rules: a
#: dropped tick-loop task, an await between the TCP listen and
#: host_pool, and the receive watermark advanced before a tear-capable
#: await
FAULT_SHAPES = {
    "tick-loop-wedge": ("async-orphan-task", "osd/_fixture_wedge.py", """
        import asyncio

        class Messenger:
            def start_tick(self, interval):
                async def tick():
                    while True:
                        await asyncio.sleep(interval)
                        await self._lease_probe()

                asyncio.get_event_loop().create_task(tick())
        """),
    "listen-yield-window": ("async-atomic-section", "daemon/_fixture.py", """
        from ceph_tpu.utils import aio

        async def serve(args, messenger, shard):
            await messenger.start()
            # cephlint: atomic-section listen-to-host-pool
            conf = await aio.read_json(args.cluster_conf)
            shard.host_pool(conf["pool"])
            # cephlint: end-atomic-section
        """),
    "watermark-before-tear": ("async-atomic-section", "msg/_fixture.py", """
        class Messenger:
            async def serve(self, framer, writer, in_key, queue):
                while True:
                    rec = await framer.next_frame()
                    seq = rec[0]
                    # cephlint: atomic-section watermark-ordering
                    if seq <= self._in_seqs.get(in_key, 0):
                        continue
                    self._in_seqs[in_key] = seq
                    await writer.drain()
                    queue.put_nowait(rec)
                    # cephlint: end-atomic-section
        """),
}


@pytest.mark.parametrize("shape", sorted(FAULT_SHAPES))
def test_fault_shapes_are_caught_by_both_packages(shape):
    rule_name, rel, src = FAULT_SHAPES[shape]
    src = textwrap.dedent(src)
    theirs = {(f.rule, f.line) for f in
              j_runner.scan_file(f"ceph_tpu/{rel}", src)}
    mine = {(f.rule, f.line) for f in
            scan_file(f"ceph_tpu_torch/{rel}", _to_port(src))}
    assert mine == theirs and rule_name in {r for r, _ in mine}


def _port_ctx(rel: str) -> FileContext:
    source = _read(REPO, os.path.join("ceph_tpu_torch", rel))
    return FileContext(f"ceph_tpu_torch/{rel}", source, ast.parse(source))


def test_callgraph_snapshot_tcp_may_await():
    from ceph_tpu_torch.analysis import callgraph

    awaiting = set(callgraph.get(_port_ctx("msg/tcp.py"))
                   .awaiting_functions())
    assert {"TCPMessenger._connect", "TCPMessenger._serve_connection_inner",
            "TCPMessenger._session_handshake", "TCPMessenger.send_message",
            "TCPMessenger._send_lossless", "TCPMessenger.probe"} <= awaiting
    assert not {"TCPMessenger._msg_entry", "TCPMessenger._entry_frames",
                "TCPMessenger._flush_now", "TCPMessenger.mark_down"} & \
        awaiting


def test_wire_trailing_compat_guards_the_reqid_evolution():
    real = _read(REPO, "ceph_tpu_torch/msg/wire.py")
    wire_rules = {"wire-schema-symmetry", "wire-trailing-compat",
                  "wire-version-pairing"}
    path = "ceph_tpu_torch/msg/wire.py"
    assert not [f for f in scan_file(path, real) if f.rule in wire_rules]
    broken = real.replace("reqid=dec.value() if dec.remaining() else None,",
                          "reqid=dec.value(),")
    assert broken != real
    assert [f for f in scan_file(path, broken) if f.rule in wire_rules]


def test_the_port_keeps_the_markers_the_rules_read():
    from ceph_tpu_torch.analysis.core import (parse_atomic_sections,
                                              parse_wire_hot_sections)

    for rel in ("msg/tcp.py", "msg/wire.py"):
        mine = _read(REPO, f"ceph_tpu_torch/{rel}")
        theirs = _read(REPO, f"ceph_tpu/{rel}")
        for marker in ("wire-optional --", "atomic-section ",
                       "wire-hot-section "):
            assert mine.count(marker) == theirs.count(marker), (rel, marker)
    tcp = _read(REPO, "ceph_tpu_torch/msg/tcp.py").splitlines()
    assert [s.name for s in parse_atomic_sections(tcp)[0]] == \
        ["msgr-watermark-ordering"]
    assert [s.name for s in parse_wire_hot_sections(tcp)[0]] == \
        ["msgr-frame-parse", "msgr-seal-flush"]


def _cli(*args):
    return subprocess.run([sys.executable, CLI, *args], capture_output=True,
                          text=True, env=ENV)


def test_rule_filter_and_runtime_in_json(tmp_path):
    dirty = tmp_path / "dirty.py"
    dirty.write_text("import time\n\nasync def f():\n    time.sleep(1)\n")
    data = json.loads(_cli("--format", "json", "--rule",
                           "async-blocking-call", str(dirty)).stdout)
    assert data["lint_findings_by_rule"] == {"async-blocking-call": 1}
    assert data["rules_run"] == ["async-blocking-call"]
    assert data["lint_runtime_secs"] >= 0
    other = _cli("--format", "json", "--rule", "async-orphan-task",
                 str(dirty))
    assert json.loads(other.stdout)["lint_findings_total"] == 0
    bad = _cli("--rule", "nope", str(dirty))
    assert bad.returncode == 2 and "known rules" in bad.stderr


def test_changed_scope(tmp_path):
    repo = tmp_path / "repo"
    (repo / "ceph_tpu_torch").mkdir(parents=True)
    (repo / "ceph_tpu_torch" / "clean.py").write_text(
        "import time\n\nasync def f():\n    time.sleep(1)\n")
    env = dict(ENV, GIT_AUTHOR_NAME="t", GIT_AUTHOR_EMAIL="t@t",
               GIT_COMMITTER_NAME="t", GIT_COMMITTER_EMAIL="t@t")
    for args in (["init", "-q"], ["add", "-A"], ["commit", "-qm", "seed"]):
        subprocess.run(["git", *args], cwd=repo, check=True,
                       capture_output=True, env=env)
    assert runner.changed_files(str(repo)) == []
    (repo / "ceph_tpu_torch" / "dirty.py").write_text(
        "import time\n\nasync def g():\n    time.sleep(1)\n")
    assert runner.changed_files(str(repo)) == ["ceph_tpu_torch/dirty.py"]
    res = runner.run_paths(runner.changed_files(str(repo)), root=str(repo))
    assert res.files_scanned == 1
    assert [f.rule for f in res.new] == ["async-blocking-call"]


#: the port's scan covers at least this many files (ceph_tpu_torch,
#: chip_smoke.py and the port's test files: 285 at its first gate)
GATE_FILES_FLOOR = 250


def test_port_gate_zero_new_findings():
    """THE port's gate: the analyzer over its default scope with the
    checked-in baseline reports zero new findings.  Fix a finding, give
    it a justified inline disable, or (accepted legacy only) regenerate
    the baseline with ``python ceph_tpu_torch/tools/cephlint.py
    --write-baseline`` and review the diff."""
    result = runner.run_paths(
        list(runner.DEFAULT_PATHS), root=REPO,
        baseline_path=os.path.join(REPO, "ceph_tpu_torch", "tools",
                                   "cephlint_baseline.json"))
    assert result.files_scanned > GATE_FILES_FLOOR
    assert not result.new, "\n".join(f.format() for f in result.new)
    assert not result.baselined
    assert result.runtime_secs < 30, f"{result.runtime_secs:.1f}s"


def test_baseline_roundtrip(tmp_path):
    src = "import time\nasync def f():\n    time.sleep(1)\n"
    f1 = tmp_path / "mod.py"
    f1.write_text(src)
    res = runner.run_paths([str(f1)], root=str(tmp_path))
    assert len(res.new) == 1
    bl = tmp_path / "baseline.json"
    baseline_mod.write(str(bl), res.new, res.file_lines,
                       res.suppression_audit)
    res2 = runner.run_paths([str(f1)], root=str(tmp_path),
                            baseline_path=str(bl))
    assert not res2.new and len(res2.baselined) == 1
    f1.write_text(src + "    time.sleep(2)\n")
    res3 = runner.run_paths([str(f1)], root=str(tmp_path),
                            baseline_path=str(bl))
    assert len(res3.new) == 1 and len(res3.baselined) == 1


def test_baseline_format_is_shared_both_ways(tmp_path):
    """A baseline written by either package's ``baseline.py`` reads in
    the other's, with the same accepted keys and the same split of the
    same findings."""
    src = ("import time\nasync def f():\n    time.sleep(1)\n"
           "    time.sleep(1)\n")
    (tmp_path / "mod.py").write_text(src)
    mine = runner.run_paths(["mod.py"], root=str(tmp_path))
    theirs = j_runner.run_paths(["mod.py"], root=str(tmp_path))
    assert [f.to_dict() for f in mine.new] == \
        [f.to_dict() for f in theirs.new]
    written = {}
    for name, mod, res in (("port", baseline_mod, mine),
                           ("jax", j_baseline, theirs)):
        written[name] = str(tmp_path / f"{name}.json")
        mod.write(written[name], res.new[:1], res.file_lines,
                  res.suppression_audit)
    for path in written.values():
        with open(path) as fh:
            assert json.load(fh)["format_version"] == \
                baseline_mod.FORMAT_VERSION == j_baseline.FORMAT_VERSION
        assert baseline_mod.load(path) == j_baseline.load(path)
        new, old = baseline_mod.split(mine.new, mine.file_lines,
                                      baseline_mod.load(path))
        j_new, j_old = j_baseline.split(theirs.new, theirs.file_lines,
                                        j_baseline.load(path))
        assert (len(new), len(old)) == (len(j_new), len(j_old)) == (1, 1)


def test_parse_error_is_a_finding(tmp_path):
    (tmp_path / "broken.py").write_text("def f(:\n")
    res = runner.run_paths(["broken.py"], root=str(tmp_path))
    assert [f.rule for f in res.new] == ["parse-error"]


def test_cli_json_format_and_exit_codes(tmp_path):
    clean = tmp_path / "clean.py"
    clean.write_text("import asyncio\n\nasync def f():\n"
                     "    await asyncio.sleep(0)\n")
    dirty = tmp_path / "dirty.py"
    dirty.write_text("import time\n\nasync def f():\n    time.sleep(1)\n")
    ok = _cli("--format", "json", str(clean))
    assert ok.returncode == 0
    assert json.loads(ok.stdout)["lint_findings_total"] == 0
    bad = _cli("--format", "json", str(dirty))
    assert bad.returncode == 1
    data = json.loads(bad.stdout)
    assert data["lint_findings_total"] == 1
    assert data["findings"][0]["rule"] == "async-blocking-call"
    assert data["counts_by_rule"] == {"async-blocking-call": 1}


def test_cli_sarif_format(tmp_path):
    dirty = tmp_path / "dirty.py"
    dirty.write_text("import time\n\nasync def f():\n    time.sleep(1)\n")
    out = _cli("--format", "sarif", str(dirty))
    assert out.returncode == 1
    run0 = json.loads(out.stdout)["runs"][0]
    assert run0["tool"]["driver"]["name"] == "cephlint"
    assert [r["ruleId"] for r in run0["results"]] == ["async-blocking-call"]
    loc = run0["results"][0]["locations"][0]["physicalLocation"]
    assert loc["region"]["startLine"] == 4
    (tmp_path / "clean.py").write_text("x = 1\n")
    ok = _cli("--format", "sarif", str(tmp_path / "clean.py"))
    assert ok.returncode == 0
    assert json.loads(ok.stdout)["runs"][0]["results"] == []


def test_ci_lint_script_drives_the_port():
    script = os.path.join(REPO, "ceph_tpu_torch", "tools", "ci_lint.sh")
    assert os.access(script, os.X_OK)
    assert subprocess.run(["sh", "-n", script]).returncode == 0
    text = _read(REPO, script)
    steps = re.findall(r"^\s*(?:exec )?python (?:-m )?(\S+)", text, re.M)
    assert steps and all(s.startswith(("ceph_tpu_torch", "-c"))
                         for s in steps), steps
    for module in ("native.wire_codec", "tools.wire_fuzz", "msg.shm_ring",
                   "tools.ec_benchmark", "osd.trace_bench",
                   "mgr.telemetry_bench", "entry"):
        assert f"ceph_tpu_torch.{module}" in text, module
    for workload in ("elastic-path", "wire-tax", "qos-path",
                     "storage-path"):
        assert f"-w {workload}" in text, workload
    assert "--device cpu" in text and "-P device=cpu" in text
    assert "set -eu" in text and "JAX_PLATFORMS" not in text


def test_residency_summary_cache_reuses_unchanged_modules():
    from ceph_tpu_torch.analysis import residency_flow

    source = _read(REPO, "ceph_tpu_torch/ops/pipeline.py")
    path = "ceph_tpu_torch/ops/pipeline.py"
    a1 = residency_flow.get(FileContext(path, source, ast.parse(source)))
    a2 = residency_flow.get(FileContext(path, source, ast.parse(source)))
    assert a1 is a2
    changed = FileContext(path, source + "\n# x\n", ast.parse(source))
    assert residency_flow.get(changed) is not a1


def test_residency_lattice_reads_the_ports_idioms():
    from ceph_tpu_torch.analysis import residency_flow as flow

    src = textwrap.dedent("""
        import numpy as np
        import torch
        from ceph_tpu_torch.ops import cuda_gf

        def f(a, dev, t):
            up = torch.from_numpy(a).to(dev, non_blocking=True)
            cast = up.to(torch.int32)
            out = cuda_gf.matrix_encode_w8(t, cast, 4, 2)
            made = torch.zeros(4, dtype=torch.uint8, device=dev)
            host = torch.zeros(4, dtype=torch.uint8, device="cpu")
            pinned = torch.empty(4, dtype=torch.uint8, pin_memory=True)
            back = out.cpu()
            summed = torch.bitwise_xor(out, made)
            return out
        """)
    analysis = flow.get(FileContext("ceph_tpu_torch/x.py", src,
                                    ast.parse(src)))
    fr = next(iter(analysis.functions.values()))
    assert {n: fr.names[n] for n in ("up", "cast", "out", "made", "host",
                                     "pinned", "back", "summed")} == {
        "up": "device", "cast": "device", "out": "device",
        "made": "device", "host": "host", "pinned": "host",
        "back": "host", "summed": "device"}
    assert fr.returns == "device" and fr.syncs  # out.cpu() is a D2H


def test_config_registry_extraction_matches_runtime():
    from ceph_tpu_torch.analysis.rules_config import declared_options

    assert set(declared_options()) == set(OPTIONS)
    # the options read only through the environment layer are declared
    # as the JAX package declares them
    for name in ("no_h2d_cache", "cli_state", "atomic_verify",
                 "residency_verify"):
        assert (OPTIONS[name].type, OPTIONS[name].default) == \
            (J_OPTIONS[name].type, J_OPTIONS[name].default), name


def test_the_jax_gate_passes_the_ports_test_files():
    """The JAX package's gate scans ``tests/``: this slice's test files
    and helper add no finding to it."""
    new_files = ["tests/test_torch_cephlint.py",
                 "tests/test_torch_native_lint.py",
                 "tests/test_torch_atomic_runtime.py",
                 "tests/torch_verify.py"]
    res = j_runner.run_paths(
        new_files, root=REPO,
        baseline_path=os.path.join(REPO, "tools", "cephlint_baseline.json"))
    assert res.files_scanned == len(new_files)
    assert not res.new, "\n".join(f.format() for f in res.new)
